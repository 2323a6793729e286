"""Asset import orchestration — raw geometry and PNG textures.

Re-creates the part of the import pipeline the reference drives in
``loadRenderObjects`` (reference ``src/mgr.cpp:274-363``) that the port
runs today: raw in-memory geometry becomes one object per mesh
(``importRawGeometry``, ``src/mgr.cpp:214-272``), additional textures are
decoded to RGBA8 (``ImageImporter::importImage``, ``src/mgr.cpp:318``) and
additional materials follow in the global material table, their texture
ids offset as ``src/mgr.cpp:316-337`` does. Object ids follow the
reference's contract (disk assets first, then raw meshes —
``scripts/test.py:7-9``); with no disk assets the raw meshes start at 0.

Disk assets (OBJ/glTF) and image formats other than PNG (KTX2, JPEG, ...)
are ROADMAP Queue 1 item 18; asking for either raises
``NotImplementedError``.

The ``Source*`` dataclasses are copies of the JAX package's
``assets/obj.py`` records; ``import_raw_geometry`` and
``load_render_assets`` are copies of its ``assets/importer.py`` functions
restricted to the raw-geometry route, so both packages bake identical
scenes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import os

import numpy as np

from ..config import AdditionalMaterial, GeometryConfig, ImportedAsset
from .png import decode_png


@dataclass
class SourceMaterial:
    """Parsed material: base color RGBA, optional texture, pbr params.

    Analog of ``madrona::imp::SourceMaterial`` (bound at reference
    ``src/bindings.cpp:38-54``).
    """

    name: str = ""
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    texture_path: Optional[str] = None
    texture_image: Optional["np.ndarray"] = None  # RGBA8 [H, W, 4]
    roughness: float = 0.8
    metalness: float = 0.2


@dataclass
class SourceMesh:
    """One triangle mesh. Analog of ``madrona::imp::SourceMesh``
    (field list pinned by reference usage ``src/mgr.cpp:246-259``)."""

    positions: np.ndarray  # float32 [V, 3]
    uvs: Optional[np.ndarray]  # float32 [V, 2] or None
    normals: Optional[np.ndarray]  # float32 [V, 3] or None
    indices: np.ndarray  # uint32 [F * 3]
    material_idx: int = -1  # into the owning object's material list; -1 none

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.indices.shape[0] // 3)


@dataclass
class SourceObject:
    """One imported asset: meshes + the materials its file declared.
    Analog of ``madrona::imp::SourceObject`` (reference ``src/mgr.cpp:267-270``)."""

    meshes: List[SourceMesh] = field(default_factory=list)
    materials: List[SourceMaterial] = field(default_factory=list)


@dataclass
class ImportedAssets:
    """Merged import result: objects + global material/texture tables.

    Analog of ``madrona::imp::ImportedAssets`` as used by the reference
    (``src/mgr.cpp:311-362``). ``objects[i].meshes[*].material_idx`` indexes
    ``materials``; ``materials[*].texture_idx`` indexes ``textures``.
    """

    objects: List[SourceObject] = field(default_factory=list)
    materials: List[AdditionalMaterial] = field(default_factory=list)
    textures: List[np.ndarray] = field(default_factory=list)  # RGBA8 [H, W, 4]


def import_raw_geometry(geo: GeometryConfig) -> List[SourceObject]:
    """Raw SoA geometry → one single-mesh SourceObject per mesh.

    Mirrors the slicing of ``importRawGeometry`` (reference
    ``src/mgr.cpp:214-272``): mesh i's vertices span
    [offset[i], offset[i+1]) with the last mesh running to the array end.
    Material ids are kept as raw *additional-material* indices here; the
    merge step offsets them into the global table.
    """
    objects: List[SourceObject] = []
    n = geo.num_meshes
    verts = np.asarray(geo.vertices, np.float32).reshape(-1, 3)
    uvs = np.asarray(geo.uvs, np.float32).reshape(-1, 2)
    indices = np.asarray(geo.indices, np.uint32).reshape(-1)
    v_off = np.asarray(geo.mesh_vertex_offsets, np.int64).reshape(-1)
    i_off = np.asarray(geo.mesh_index_offsets, np.int64).reshape(-1)
    mats = np.asarray(geo.mesh_materials, np.int64).reshape(-1)
    for i in range(n):
        v0 = int(v_off[i])
        v1 = int(v_off[i + 1]) if i + 1 < n else verts.shape[0]
        i0 = int(i_off[i])
        i1 = int(i_off[i + 1]) if i + 1 < n else indices.shape[0]
        mesh = SourceMesh(
            positions=verts[v0:v1].copy(),
            uvs=uvs[v0:v1].copy() if uvs.shape[0] >= v1 else None,
            normals=None,
            indices=indices[i0:i1].astype(np.uint32),
            material_idx=int(mats[i]),
        )
        objects.append(SourceObject(meshes=[mesh], materials=[]))
    return objects


def import_image(path: str) -> np.ndarray:
    """One texture file → RGBA8 ``[H, W, 4]`` (the JAX package's
    ``ImageImporter.import_image`` for the PNG handler)."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext != "png":
        raise NotImplementedError(
            f"'.{ext}' textures are not ported yet (PNG only) — ROADMAP "
            f"Queue 1 item 18 ({path})"
        )
    with open(path, "rb") as f:
        return decode_png(f.read())


def load_render_assets(
    geo_cfg: GeometryConfig,
    asset_paths: Sequence[ImportedAsset],
    additional_mats: Sequence[AdditionalMaterial],
    additional_textures: Sequence[str],
) -> ImportedAssets:
    """Raw geometry + additional textures and materials, merged as
    ``loadRenderObjects`` does (``src/mgr.cpp:274-363``) when no disk asset
    is given."""
    if len(asset_paths):
        raise NotImplementedError(
            "disk assets (asset_paths) are not ported yet — ROADMAP Queue 1 "
            "item 18; pass the meshes as raw geometry"
        )
    out = ImportedAssets()
    tex_path_to_idx = {}

    def intern_texture(path: str) -> int:
        if path not in tex_path_to_idx:
            tex_path_to_idx[path] = len(out.textures)
            out.textures.append(import_image(path))
        return tex_path_to_idx[path]

    # No disk asset precedes them, so the pre-existing texture and
    # material counts of src/mgr.cpp:316-337 are 0.
    add_tex_ids = [intern_texture(p) for p in additional_textures]
    for mat in additional_mats:
        tex = int(mat.texture_id)
        if tex != -1:
            tex = add_tex_ids[tex] if tex < len(add_tex_ids) else tex
        out.materials.append(
            AdditionalMaterial(
                color=tuple(mat.color),
                texture_id=tex,
                roughness=mat.roughness,
                metalness=mat.metalness,
            )
        )
    # Raw meshes' material ids index the additional-material list, which
    # starts the global table (no asset-file materials precede it).
    out.objects.extend(import_raw_geometry(geo_cfg))
    return out

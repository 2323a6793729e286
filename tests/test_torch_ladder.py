"""PyTorch port: the GPU health ladder (madrona_renderer_tpu_torch/ladder.py)
== tools/tpu_ladder.py.

The TPU tool's three Pallas probes run here in interpret mode (the test
wraps ``jax.experimental.pallas.pallas_call`` so it passes
``interpret=True`` and records the call's inputs and output) and their
values are held bitwise against the port's plain versions of L1-L3 on the
same inputs; the port keeps the tool's rungs in the tool's order; and
without a card the ladder stops at its first rung with a non-zero exit (no
CPU fallback), while the probes' wrappers take their plain versions only
for tensors on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from madrona_renderer_tpu_torch import ladder
from tools import tpu_ladder

ROOT = Path(__file__).resolve().parent.parent
PROBES = {"pallas_copy": "ladder_copy", "pallas_grid_smem": "ladder_grid_smem",
          "pallas_fori_smem": "ladder_fori_smem"}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_plain_versions_match_the_jax_probes(probe, monkeypatch):
    """The tool's probe (its own asserts included) in interpret mode: its
    inputs are the port's ``probe_inputs`` and its output the port's plain
    version's, bitwise; the wrapper on CPU tensors is the plain version."""
    real = pl.pallas_call
    calls = []

    def interpreted(*a, **k):
        f = real(*a, **dict(k, interpret=True))

        def run(*args):
            out = f(*args)
            calls.append(([np.asarray(x) for x in args], np.asarray(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    getattr(tpu_ladder, probe)()
    assert len(calls) == 1
    (jax_args, jax_out), = calls
    name = PROBES[probe]
    args = ladder.probe_inputs("cpu")[name]
    assert len(args) == len(jax_args)
    for a, j in zip(args, jax_args):
        np.testing.assert_array_equal(a.numpy().reshape(j.shape), j)
    plain = ladder.PLAIN[name](*args)
    np.testing.assert_array_equal(plain.numpy().reshape(jax_out.shape), jax_out)
    assert torch.equal(ladder.WRAPPERS[name](*args), plain)
    assert ladder.WRAPPERS[name].launches == 0


def test_rungs_are_the_tools():
    """The same rungs in the same order: a card that fails shows where."""
    assert ladder.RUNGS == tuple(tpu_ladder.RUNGS)
    assert all(callable(getattr(ladder, r)) for r in ladder.RUNGS)


def test_no_card_fails_at_the_first_rung():
    """Without a card (none visible) the ladder exits non-zero, naming its
    first rung, and runs no other."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "madrona_renderer_tpu_torch.ladder"],
                          cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "FAIL at rung 'basic_op'" in proc.stdout, proc.stdout[-2000:]
    assert "no CUDA device" in proc.stdout
    assert "ok " not in proc.stdout and "pallas_copy" not in proc.stdout


def test_probes_never_fall_back():
    """Tensors off the CPU never take the plain path: the wrappers launch
    their kernel there or raise (here: 'meta' tensors); bad shapes raise."""
    meta = {k: tuple(x.to("meta") for x in v) for k, v in ladder.probe_inputs("cpu").items()}
    for name, args in meta.items():
        with pytest.raises(ValueError, match="cuda or cpu"):
            ladder.WRAPPERS[name](*args)
    with pytest.raises(ValueError, match="rows must be"):
        ladder.fori_smem(torch.zeros((2, 3, 2048)))
    with pytest.raises(ValueError, match="4 float32 values"):
        ladder.grid_smem(torch.zeros(3), torch.zeros((4, 8, 128)))

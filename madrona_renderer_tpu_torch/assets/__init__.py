"""Asset import (the raw-geometry route; see importer.py)."""

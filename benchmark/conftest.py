"""A CPU size for the tile-grid entry in the tests' ``fixtures.TINY``.

``tests/fixtures.py`` gives each entry of a configuration a configuration
small enough for the CPU (``tiny_spec``); a configuration on the entry
``tile_grid_row`` runs there at the 3x2 carve on 96x144, 6 x 9 MBs: three
band-rows of 3 MB rows, two tile columns of 3 MBs, the least geometry
that holds the carve (``MIN_BAND_MB_ROWS``, ``MIN_TILE_MB_COLS``).
"""

import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

import fixtures  # noqa: E402

TILE_GRID_CPU = {"entry": "tile_grid_row", "row": "tpuh264enc", "width": 96, "height": 144,
                 "bands": 3, "cols": 2, "fps": 30, "sessions": 1, "qp": 28, "static_skip": True,
                 "reduced": []}
fixtures.TINY.setdefault("tile_grid_row", TILE_GRID_CPU)

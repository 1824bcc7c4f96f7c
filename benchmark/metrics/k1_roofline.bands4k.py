"""K1's share of its HBM roofline in the traced stretch, at a tile's contract: the least time of one call on a tile of the configuration's grid (its rows and columns of pixels, the reference padded by 40 each side) over K1's mean device time."""

from yardstick.roofline import bandwidth_share, k1_bytes

LAYER = "K1 ME/MC kernel"
SOURCE = "device_trace"
MOVES = "au_bytes"
WORKLOADS = ["bands4k.motion"]


def tile(cfg: dict) -> tuple[int, int]:
    """(rows, columns) of pixels of one tile of the configuration's grid."""
    h, w = (int(cfg["height"]) + 15) // 16, (int(cfg["width"]) + 15) // 16
    return 16 * (h // int(cfg["bands"])), 16 * (w // int(cfg["cols"]))


def read(run):
    act = run.activity
    n, mean_s = act.kernel("me_mc_kernel") if act is not None else (0, 0.0)
    if not n:
        return None
    return bandwidth_share(k1_bytes(*tile(run.config)), mean_s)

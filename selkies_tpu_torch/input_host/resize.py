"""Dynamic server-side display resize (xrandr driver).

The port's copy of ``selkies_tpu/input_host/resize.py``, unchanged.

Parity target: reference resize.py — fit the requested WxH under the output
ceiling (7680x4320, or 2560x1600 on DVI outputs), create the mode with a
``cvt -r`` reduced-blanking modeline when missing, apply it with xrandr,
and set DPI / cursor size through xfconf.  All shell-outs run through one
``_run`` helper and are injectable for tests (no X needed).
"""

from __future__ import annotations

import logging
import re
import subprocess
from shutil import which
from typing import Callable

logger = logging.getLogger("resize")

MAX_RES = (7680, 4320)
MAX_RES_DVI = (2560, 1600)  # hardware-accelerator ceiling on DVI outputs

Runner = Callable[[list[str]], "subprocess.CompletedProcess[str]"]


def _run(cmd: list[str]) -> "subprocess.CompletedProcess[str]":
    return subprocess.run(cmd, capture_output=True, text=True, timeout=10)


def fit_res(w: int, h: int, max_w: int, max_h: int) -> tuple[int, int]:
    """Scale (w, h) down uniformly until it fits, snapped to even."""
    if w < max_w and h < max_h:
        return w, h
    scale = min(max_w / w, max_h / h)
    new_w, new_h = int(w * scale), int(h * scale)
    return new_w + new_w % 2, new_h + new_h % 2


def parse_xrandr(output: str) -> tuple[str | None, str | None, list[str]]:
    """Return (connected output name, current WxH, supported mode list)."""
    screen_name = None
    current = None
    modes: list[str] = []
    for line in output.splitlines():
        line = line.strip()
        m = re.match(r"(\S+) connected", line)
        if m:
            screen_name = m.group(1)
        m = re.match(r".*current (\d+) x (\d+).*", line)
        if m:
            current = f"{m.group(1)}x{m.group(2)}"
        if screen_name is not None:
            m = re.match(r"^(\d+x\d+)\s", line)
            if m:
                modes.append(m.group(1))
    return screen_name, current, sorted(modes)


def get_new_res(res: str, runner: Runner = _run):
    """(curr_res, fitted_res, modes, max_res, screen_name) for a request."""
    out = runner(["xrandr"]).stdout
    screen_name, curr_res, modes = parse_xrandr(out)
    if screen_name is None:
        logger.error("no connected output in xrandr output")
        return curr_res or res, res, modes, res, None
    max_w, max_h = MAX_RES_DVI if screen_name.startswith("DVI") else MAX_RES
    w, h = (int(v) for v in res.split("x"))
    new_w, new_h = fit_res(w, h, max_w, max_h)
    return curr_res or res, f"{new_w}x{new_h}", modes, f"{max_w}x{max_h}", screen_name


def generate_modeline(res: str, runner: Runner = _run) -> tuple[str, str]:
    """Reduced-blanking CVT modeline for "WxH" / "W H" / "W H hz" input."""
    if "x" in res:
        w, h = res.split("x")
        hz = "60"
    else:
        parts = res.split()
        if len(parts) == 2:
            (w, h), hz = parts, "60"
        elif len(parts) == 3:
            w, h, hz = parts
        else:
            raise ValueError(f"unsupported resolution format: {res!r}")
    out = runner(["cvt", "-r", w, h, hz]).stdout
    m = re.search(r'Modeline\s+"[^"]*"\s+(.*)', out)
    if not m:
        raise RuntimeError(f"cvt produced no modeline for {res!r}")
    return f"{w}x{h}", m.group(1).strip()


def resize_display(res: str, runner: Runner = _run) -> bool:
    """Apply a WxH resolution, creating the xrandr mode if needed."""
    curr_res, new_res, modes, _max_res, screen_name = get_new_res(res, runner)
    if screen_name is None:
        return False
    if curr_res == new_res:
        logger.info("display already %s, skipping resize", new_res)
        return False
    if new_res not in modes:
        mode, modeline = generate_modeline(new_res, runner)
        r = runner(["xrandr", "--newmode", mode, *modeline.split()])
        if r.returncode != 0:
            logger.error("xrandr --newmode failed: %s%s", r.stdout, r.stderr)
            return False
        r = runner(["xrandr", "--addmode", screen_name, mode])
        if r.returncode != 0:
            logger.error("xrandr --addmode failed: %s%s", r.stdout, r.stderr)
            return False
    r = runner(["xrandr", "--output", screen_name, "--mode", new_res])
    if r.returncode != 0:
        logger.error("xrandr --output failed: %s%s", r.stdout, r.stderr)
        return False
    logger.info("display resized to %s", new_res)
    return True


def set_dpi(dpi: int, runner: Runner = _run) -> bool:
    if not which("xfconf-query"):
        logger.warning("xfconf-query not found; cannot set DPI")
        return False
    r = runner(["xfconf-query", "-c", "xsettings", "-p", "/Xft/DPI",
                "-s", str(dpi), "--create", "-t", "int"])
    if r.returncode != 0:
        logger.error("failed to set DPI %d: %s%s", dpi, r.stdout, r.stderr)
        return False
    return True


def set_cursor_size(size: int, runner: Runner = _run) -> bool:
    if not which("xfconf-query"):
        logger.warning("xfconf-query not found; cannot set cursor size")
        return False
    r = runner(["xfconf-query", "-c", "xsettings", "-p", "/Gtk/CursorThemeSize",
                "-s", str(size), "--create", "-t", "int"])
    if r.returncode != 0:
        logger.error("failed to set cursor size %d: %s%s", size, r.stdout, r.stderr)
        return False
    return True


def entrypoint() -> None:
    """Console script ``selkies-tpu-resize WxH``."""
    import sys

    logging.basicConfig(level=logging.INFO)
    if len(sys.argv) < 2:
        print(f"USAGE: {sys.argv[0]} WxH")
        raise SystemExit(1)
    print(resize_display(sys.argv[1]))


if __name__ == "__main__":
    entrypoint()

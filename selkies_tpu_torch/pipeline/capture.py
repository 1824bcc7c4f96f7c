"""X11 screen capture: the stack's ximagesrc.

The port's copy of ``selkies_tpu/pipeline/capture.py``, unchanged; without
a display ``make_frame_source`` returns the port's
``pipeline.elements.SyntheticSource``.

The reference's frame source is GStreamer `ximagesrc` with MIT-SHM
(gstwebrtc_app.py:210-241, `ximagesrc show-pointer=0 remote=1`). This is
the ctypes re-implementation: an `XShmGetImage` grab of the root window
into a shared-memory segment (zero-copy from the X server), exposed as the
pipeline's FrameSource protocol — `capture()` returns (H, W, 4) BGRx
uint8, exactly what `ops/colorspace.bgrx_to_i420` expects on device.

Fallbacks, in order:
  * MIT-SHM unavailable (remote DISPLAY, missing extension) → plain
    `XGetImage` round trips (slower, still correct — ximagesrc does the
    same when xshm is off).
  * no DISPLAY / no libX11 → callers catch `X11Unavailable` and use
    `SyntheticSource` (parity with headless test rigs).

The capture connection is private to this object: X11 Display handles are
not thread-safe, and capture runs on a worker thread while the input host
owns its own connection.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from selkies_tpu_torch.input_host.x11 import X11Unavailable, _load

logger = logging.getLogger("pipeline.capture")

_ZPIXMAP = 2
_ALL_PLANES = ctypes.c_ulong(-1 & 0xFFFFFFFFFFFFFFFF)
_IPC_PRIVATE = 0
_IPC_CREAT = 0o1000
_IPC_RMID = 0
_GEOMETRY_POLL_S = 1.0  # resize detection interval (avoid a sync X round trip per frame)
_DAMAGE_REPORT_RAW_RECTANGLES = 0  # XDamageReportRawRectangles (damagewire.h)
_XEVENT_BYTES = 192  # sizeof(XEvent): 24 longs on LP64
# past this many rects per drain the damage plainly covers most of the
# frame and the hint saves nothing — publish "unknown" (full scan)
# instead of paying per-rect bookkeeping in exactly the busy regime
_DAMAGE_MAX_RECTS = 256

# Xlib's default error handler calls exit(1) on any async error (e.g. the
# server rejecting XShmAttach for a remote client) — install a recording
# handler so SHM failures fall back to XGetImage instead of killing the
# process. Global per libX11, installed once.
_ERROR_HANDLER_TYPE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
_last_x_error: list[int] = []


@_ERROR_HANDLER_TYPE
def _record_x_error(dpy, event):
    _last_x_error.append(1)
    return 0


_handler_installed = False


def pad_frame_to_even(frame: np.ndarray) -> np.ndarray:
    """Edge-replicate a BGRx frame's last column/row when its geometry is
    odd (returns the frame unchanged when already even).

    4:2:0 chroma siting cannot express an odd luma dimension — H.264's
    frame cropping works in 2-sample units and every converter in the
    stack walks 2x2 pixel quads — so odd root-window geometry (DCI
    projectors at 4096x2161 panning strips, xrandr splits) is normalized
    HERE, at the capture boundary: the encoder is built at the even
    size, the stream carries one replicated edge column/row, and nothing
    downstream ever sees an odd plane."""
    h, w = frame.shape[:2]
    if not (h & 1 or w & 1):
        return frame
    return np.ascontiguousarray(
        np.pad(frame, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge"))


def _install_error_handler(x) -> None:
    global _handler_installed
    if not _handler_installed:
        x.XSetErrorHandler.restype = ctypes.c_void_p
        x.XSetErrorHandler.argtypes = [_ERROR_HANDLER_TYPE]
        x.XSetErrorHandler(_record_x_error)
        _handler_installed = True


class _XShmSegmentInfo(ctypes.Structure):
    _fields_ = [
        ("shmseg", ctypes.c_ulong),
        ("shmid", ctypes.c_int),
        ("shmaddr", ctypes.c_void_p),
        ("readOnly", ctypes.c_int),
    ]


class _XRectangle(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_short), ("y", ctypes.c_short),
        ("width", ctypes.c_ushort), ("height", ctypes.c_ushort),
    ]


class _XDamageNotifyEvent(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int),
        ("serial", ctypes.c_ulong),
        ("send_event", ctypes.c_int),
        ("display", ctypes.c_void_p),
        ("drawable", ctypes.c_ulong),
        ("damage", ctypes.c_ulong),
        ("level", ctypes.c_int),
        ("more", ctypes.c_int),
        ("timestamp", ctypes.c_ulong),
        ("area", _XRectangle),
        ("geometry", _XRectangle),
    ]


_DESTROY_IMAGE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


class _XImageFuncs(ctypes.Structure):
    _fields_ = [
        ("create_image", ctypes.c_void_p),
        ("destroy_image", _DESTROY_IMAGE),
        ("get_pixel", ctypes.c_void_p),
        ("put_pixel", ctypes.c_void_p),
        ("sub_image", ctypes.c_void_p),
        ("add_pixel", ctypes.c_void_p),
    ]


class _XImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("xoffset", ctypes.c_int),
        ("format", ctypes.c_int),
        ("data", ctypes.c_void_p),
        ("byte_order", ctypes.c_int),
        ("bitmap_unit", ctypes.c_int),
        ("bitmap_bit_order", ctypes.c_int),
        ("bitmap_pad", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("bytes_per_line", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
        ("red_mask", ctypes.c_ulong),
        ("green_mask", ctypes.c_ulong),
        ("blue_mask", ctypes.c_ulong),
        ("obdata", ctypes.c_void_p),
        ("f", _XImageFuncs),
    ]


class X11CaptureSource:
    """Root-window frame source over MIT-SHM (FrameSource protocol)."""

    def __init__(self, display_name: str | None = None, use_shm: bool = True):
        x = _load("libX11.so.6", "libX11.so")
        if x is None:
            raise X11Unavailable("libX11 not found")
        self._x = x
        self._declare_x(x)
        name = display_name if display_name is not None else os.environ.get("DISPLAY")
        if not name:
            raise X11Unavailable("DISPLAY is not set")
        self._dpy = x.XOpenDisplay(name.encode())
        if not self._dpy:
            raise X11Unavailable(f"cannot open display {name!r}")
        _install_error_handler(x)
        self._screen = x.XDefaultScreen(self._dpy)
        self._root = x.XDefaultRootWindow(self._dpy)
        # raw X geometry drives the grabs; the PUBLIC width/height (what
        # the pipeline builds the encoder from) round odd dims up to
        # even, matching the pad_frame_to_even normalization capture()
        # applies to every returned frame
        self._raw_w, self._raw_h = self._root_geometry()
        self.width = self._raw_w + (self._raw_w & 1)
        self.height = self._raw_h + (self._raw_h & 1)
        self._last_geom_check = 0.0

        self._libc = _load("libc.so.6", "libc.so")
        self._xext = _load("libXext.so.6", "libXext.so") if use_shm else None
        self._shm_img = None  # POINTER(_XImage) when the SHM path is live
        self._shm_info = None
        if self._xext is not None and self._libc is not None:
            self._declare_shm(self._xext, self._libc)
            if self._xext.XShmQueryExtension(self._dpy):
                try:
                    self._setup_shm(self._raw_w, self._raw_h)
                except OSError as e:
                    logger.warning("MIT-SHM setup failed (%s); using XGetImage", e)
        if self._shm_img is None:
            logger.info("capture via XGetImage round trips (no MIT-SHM)")
        # XDamage dirty-rect hints (the reference's ximagesrc analogue):
        # the damage-bounded classifier (FramePrep.scan) reads
        # `last_damage` — a SUPERSET of the pixels that changed since the
        # previous grab, or None when unknown (full scan). Fail-soft: no
        # libXdamage / remote display / SELKIES_XDAMAGE=0 just means
        # every frame scans fully, exactly the pre-hint behaviour.
        self.last_damage: list[tuple[int, int, int, int]] | None = None
        self._xdmg = None
        self._damage_handle = 0
        self._damage_event_base = 0
        self._prev_drain: list[tuple[int, int, int, int]] | None = None
        if os.environ.get("SELKIES_XDAMAGE", "1") != "0":
            try:
                self._setup_damage()
            except (OSError, AttributeError) as e:
                logger.info("XDamage unavailable (%s); full-frame scans", e)
                self._xdmg = None

    # -- ctypes declarations -------------------------------------------

    @staticmethod
    def _declare_x(x) -> None:
        vp, ul, i, ui = ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_uint
        x.XOpenDisplay.restype = vp
        x.XOpenDisplay.argtypes = [ctypes.c_char_p]
        x.XDefaultScreen.restype = i
        x.XDefaultScreen.argtypes = [vp]
        x.XDefaultRootWindow.restype = ul
        x.XDefaultRootWindow.argtypes = [vp]
        x.XDefaultVisual.restype = vp
        x.XDefaultVisual.argtypes = [vp, i]
        x.XDefaultDepth.restype = i
        x.XDefaultDepth.argtypes = [vp, i]
        x.XGetGeometry.restype = i
        x.XGetGeometry.argtypes = [
            vp, ul, ctypes.POINTER(ul), ctypes.POINTER(i), ctypes.POINTER(i),
            ctypes.POINTER(ui), ctypes.POINTER(ui), ctypes.POINTER(ui), ctypes.POINTER(ui),
        ]
        x.XGetImage.restype = ctypes.POINTER(_XImage)
        x.XGetImage.argtypes = [vp, ul, i, i, ui, ui, ul, i]
        x.XSync.argtypes = [vp, i]
        x.XCloseDisplay.argtypes = [vp]

    @staticmethod
    def _declare_shm(xext, libc) -> None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        xext.XShmQueryExtension.restype = i
        xext.XShmQueryExtension.argtypes = [vp]
        xext.XShmCreateImage.restype = ctypes.POINTER(_XImage)
        xext.XShmCreateImage.argtypes = [
            vp, vp, ctypes.c_uint, i, vp, ctypes.POINTER(_XShmSegmentInfo),
            ctypes.c_uint, ctypes.c_uint,
        ]
        xext.XShmAttach.restype = i
        xext.XShmAttach.argtypes = [vp, ctypes.POINTER(_XShmSegmentInfo)]
        xext.XShmDetach.argtypes = [vp, ctypes.POINTER(_XShmSegmentInfo)]
        xext.XShmGetImage.restype = i
        xext.XShmGetImage.argtypes = [vp, ctypes.c_ulong, ctypes.POINTER(_XImage), i, i, ctypes.c_ulong]
        libc.shmget.restype = i
        libc.shmget.argtypes = [i, ctypes.c_size_t, i]
        libc.shmat.restype = vp
        libc.shmat.argtypes = [i, vp, i]
        libc.shmdt.argtypes = [vp]
        libc.shmctl.argtypes = [i, i, vp]

    # -- XDamage dirty-rect hints ---------------------------------------

    def _setup_damage(self) -> None:
        xd = _load("libXdamage.so.1", "libXdamage.so")
        if xd is None:
            raise OSError("libXdamage not found")
        vp, i, ul = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulong
        xd.XDamageQueryExtension.restype = i
        xd.XDamageQueryExtension.argtypes = [vp, ctypes.POINTER(i),
                                             ctypes.POINTER(i)]
        xd.XDamageCreate.restype = ul
        xd.XDamageCreate.argtypes = [vp, ul, i]
        xd.XDamageDestroy.argtypes = [vp, ul]
        xd.XDamageSubtract.argtypes = [vp, ul, ul, ul]
        self._x.XPending.restype = i
        self._x.XPending.argtypes = [vp]
        self._x.XNextEvent.argtypes = [vp, ctypes.c_void_p]
        ev_base, err_base = ctypes.c_int(0), ctypes.c_int(0)
        if not xd.XDamageQueryExtension(self._dpy, ctypes.byref(ev_base),
                                        ctypes.byref(err_base)):
            raise OSError("XDamage extension not present")
        _last_x_error.clear()
        # raw rectangles: one event per drawing op, so the drain below
        # sees every damaged area without a region fetch round trip
        handle = xd.XDamageCreate(self._dpy, self._root,
                                  _DAMAGE_REPORT_RAW_RECTANGLES)
        self._x.XSync(self._dpy, 0)
        if not handle or _last_x_error:
            raise OSError("XDamageCreate rejected")
        self._xdmg = xd
        self._damage_handle = handle
        self._damage_event_base = ev_base.value
        logger.info("XDamage dirty-rect hints armed (event base %d)",
                    ev_base.value)

    def _teardown_damage(self) -> None:
        if self._xdmg is not None and self._damage_handle:
            self._xdmg.XDamageDestroy(self._dpy, self._damage_handle)
            self._damage_handle = 0
        self._xdmg = None

    def _drain_damage(self) -> None:
        """Collect the damage rects delivered since the previous drain
        and publish `last_damage`.

        Ordering contract (the superset guarantee): this runs AFTER the
        grab plus an XSync, so every draw that landed before the grab's
        server time has its event in the queue. A draw racing the grab
        may deliver its event to THIS drain while its pixels only land
        in the NEXT grab — so the published hint is the union of the
        current and previous drains, which covers both sides of the
        race at the cost of one frame of extra rects."""
        ev = ctypes.create_string_buffer(_XEVENT_BYTES)
        rects: list[tuple[int, int, int, int]] = []
        notify_type = self._damage_event_base  # XDamageNotify = base + 0
        overflow = False
        while self._x.XPending(self._dpy):
            # the queue must drain either way (unconsumed events grow
            # without bound); past the cap we stop parsing rects — a
            # busy full-repaint frame gains nothing from hints and
            # should not pay per-rect bookkeeping (raw-rectangle
            # reporting is kept because the coalescing levels need a
            # region fetch round trip to read the area back)
            self._x.XNextEvent(self._dpy, ev)
            etype = ctypes.cast(ev, ctypes.POINTER(ctypes.c_int)).contents.value
            if etype == notify_type and not overflow:
                dn = ctypes.cast(ev, ctypes.POINTER(_XDamageNotifyEvent)).contents
                rects.append((int(dn.area.x), int(dn.area.y),
                              int(dn.area.width), int(dn.area.height)))
                overflow = len(rects) > _DAMAGE_MAX_RECTS
        # keep the accumulated region empty (raw events keep firing
        # either way; an ever-growing region costs server memory)
        self._xdmg.XDamageSubtract(self._dpy, self._damage_handle, 0, 0)
        if overflow:
            # unknown coverage: this frame AND the next must full-scan
            # (the next frame's union would otherwise miss this drain)
            self._prev_drain = None
            self.last_damage = None
            return
        if self._prev_drain is None:
            # first drain since (re)arming/overflow: no usable reference
            self.last_damage = None
        else:
            self.last_damage = self._prev_drain + rects
        self._prev_drain = rects

    # -- SHM lifecycle --------------------------------------------------

    def _setup_shm(self, w: int, h: int) -> None:
        visual = self._x.XDefaultVisual(self._dpy, self._screen)
        depth = self._x.XDefaultDepth(self._dpy, self._screen)
        info = _XShmSegmentInfo()
        img = self._xext.XShmCreateImage(
            self._dpy, visual, depth, _ZPIXMAP, None, ctypes.byref(info), w, h
        )
        if not img:
            raise OSError("XShmCreateImage failed")
        size = img.contents.bytes_per_line * img.contents.height
        shmid = self._libc.shmget(_IPC_PRIVATE, size, _IPC_CREAT | 0o600)
        if shmid < 0:
            raise OSError("shmget failed")
        addr = self._libc.shmat(shmid, None, 0)
        if addr in (None, ctypes.c_void_p(-1).value):
            self._libc.shmctl(shmid, _IPC_RMID, None)
            raise OSError("shmat failed")
        info.shmid = shmid
        info.shmaddr = addr
        info.readOnly = 0
        img.contents.data = addr
        _last_x_error.clear()
        attached = self._xext.XShmAttach(self._dpy, ctypes.byref(info))
        self._x.XSync(self._dpy, 0)  # flush any async BadAccess from the server
        if not attached or _last_x_error:
            self._libc.shmdt(addr)
            self._libc.shmctl(shmid, _IPC_RMID, None)
            raise OSError("XShmAttach rejected (remote display?)")
        # mark for deletion now: the kernel keeps it until both the server
        # and we detach, so a crash can't leak the segment
        self._libc.shmctl(shmid, _IPC_RMID, None)
        self._shm_img = img
        self._shm_info = info

    def _teardown_shm(self) -> None:
        if self._shm_img is None:
            return
        self._xext.XShmDetach(self._dpy, ctypes.byref(self._shm_info))
        self._x.XSync(self._dpy, 0)
        self._shm_img.contents.data = None
        self._shm_img.contents.f.destroy_image(ctypes.cast(self._shm_img, ctypes.c_void_p))
        self._libc.shmdt(self._shm_info.shmaddr)
        self._shm_img = None
        self._shm_info = None

    def _root_geometry(self) -> tuple[int, int]:
        root_ret = ctypes.c_ulong(0)
        xr, yr = ctypes.c_int(0), ctypes.c_int(0)
        w, h = ctypes.c_uint(0), ctypes.c_uint(0)
        bw, depth = ctypes.c_uint(0), ctypes.c_uint(0)
        ok = self._x.XGetGeometry(
            self._dpy, self._root, ctypes.byref(root_ret), ctypes.byref(xr),
            ctypes.byref(yr), ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(bw), ctypes.byref(depth),
        )
        if not ok:
            raise X11Unavailable("XGetGeometry failed")
        return int(w.value), int(h.value)

    # -- FrameSource ----------------------------------------------------

    def capture(self) -> np.ndarray:
        """Grab the root window as (H, W, 4) BGRx uint8.

        Tracks xrandr resizes: root geometry is polled at most once per
        second (a sync X round trip — too costly per frame at 60 fps); on
        change the SHM image is re-armed at the new size and subsequent
        grabs return the new geometry. The pipeline watches width/height
        and rebuilds the encoder when they move."""
        import time as _time

        now = _time.monotonic()
        if now - self._last_geom_check >= _GEOMETRY_POLL_S:
            self._last_geom_check = now
            w, h = self._root_geometry()
            if (w, h) != (self._raw_w, self._raw_h):
                logger.info("display resized %dx%d -> %dx%d",
                            self._raw_w, self._raw_h, w, h)
                if self._shm_img is not None:
                    self._teardown_shm()
                    self._setup_shm(w, h)
                self._raw_w, self._raw_h = w, h
                self.width, self.height = w + (w & 1), h + (h & 1)
                # geometry moved: pending damage rects describe the old
                # layout — force one full scan
                self._prev_drain = None
                self.last_damage = None
        if self._shm_img is not None:
            if not self._xext.XShmGetImage(
                self._dpy, self._root, self._shm_img, 0, 0, _ALL_PLANES
            ):
                raise RuntimeError("XShmGetImage failed")
            img = self._shm_img.contents
            buf = ctypes.string_at(img.data, img.bytes_per_line * img.height)
            frame = np.frombuffer(buf, np.uint8).reshape(img.height, img.bytes_per_line)
            if self._xdmg is not None:
                # after the grab: XShmGetImage's reply serialized every
                # earlier damage event into the queue (see _drain_damage)
                self._drain_damage()
            return pad_frame_to_even(np.ascontiguousarray(
                frame[:, : img.width * 4].reshape(img.height, img.width, 4)))
        # raw geometry, not the poll's locals: within the 1 s poll
        # interval `w`/`h` are unbound here (the XGetImage fallback used
        # to NameError on every frame between polls)
        ptr = self._x.XGetImage(
            self._dpy, self._root, 0, 0, self._raw_w, self._raw_h,
            _ALL_PLANES, _ZPIXMAP
        )
        if not ptr:
            raise RuntimeError("XGetImage failed")
        try:
            img = ptr.contents
            buf = ctypes.string_at(img.data, img.bytes_per_line * img.height)
            frame = np.frombuffer(buf, np.uint8).reshape(img.height, img.bytes_per_line)
            if self._xdmg is not None:
                self._drain_damage()
            return pad_frame_to_even(np.ascontiguousarray(
                frame[:, : img.width * 4].reshape(img.height, img.width, 4)))
        finally:
            ptr.contents.f.destroy_image(ctypes.cast(ptr, ctypes.c_void_p))

    def close(self) -> None:
        if self._dpy:
            self._teardown_damage()
            self._teardown_shm()
            self._x.XCloseDisplay(self._dpy)
            self._dpy = None

    @property
    def using_shm(self) -> bool:
        return self._shm_img is not None


def make_frame_source(width: int, height: int, display: str | None = None):
    """ximagesrc-or-videotestsrc selection: X11 capture when a DISPLAY is
    reachable, SyntheticSource otherwise (mirrors how test rigs run the
    reference against Xvfb, addons/conda selkies-gstreamer-run:25-30)."""
    try:
        src = X11CaptureSource(display)
        logger.info(
            "X11 capture %dx%d (shm=%s)", src.width, src.height, src.using_shm
        )
        return src
    except X11Unavailable as e:
        logger.info("X11 capture unavailable (%s); synthetic source", e)
        from selkies_tpu_torch.pipeline.elements import SyntheticSource

        return SyntheticSource(width, height)

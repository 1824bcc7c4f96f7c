"""Faults planted under a cell's timed path, for the tests and for runs on the card.

Each ``plant(entry)`` breaks the program underneath the entry that the
window drives, after set-up has built it; a sound check reads every such
run as not correct. ``APPLIES`` says which entries a fault can reach.

    python3 benchmark/control.py --workload <cell> --seeds <a,b,c> --fault <name>

runs a cell with one of them planted.
"""

from __future__ import annotations


def state_unchanged(entry):
    """The step hands back its input reference as the new one."""
    if hasattr(entry, "service"):
        enc = entry.service.enc
        step = enc.step_groups

        def frozen(inputs, qps, idrs, **kw):
            old = [g.ref for g in enc.groups]
            out = step(inputs, qps, idrs, **kw)
            if all(r is not None for r in old):
                for g, r in zip(enc.groups, old):
                    g.ref = r
            return out

        enc.step_groups = frozen
        return
    enc = entry.enc
    if hasattr(enc, "_step_p"):        # the band- or tile-sliced encoder
        step_p = enc._step_p

        def held(*args, **kw):
            # the reference planes are the step's last three positional arguments
            return (*step_p(*args, **kw)[:2], *args[-3:])

        enc._step_p = held
        return
    step = enc._step_tiles

    def frozen(tiles, qp, *, idr=False, stash=None):
        old = enc._ref
        out = step(tiles, qp, idr=idr, stash=stash)
        return out if idr or old is None else (*out[:3], *old)

    enc._step_tiles = frozen


def half_batch(entry):
    """The tick encodes the first half of its sessions' frames in place of
    the second half's."""
    svc = entry.service
    dispatch = svc.dispatch_tick

    def half(frames):
        f = frames.copy()
        k = len(f) // 2
        f[k:2 * k] = f[:k]
        return dispatch(f)

    svc.dispatch_tick = half


def altered(entry):
    """One byte of every P frame's AU is changed where the AU is made."""
    def flip(au: bytes) -> bytes:
        return au[:-2] + bytes([au[-2] ^ 0x10]) + au[-1:]

    if hasattr(entry, "service"):
        svc = entry.service
        pack = svc._pack_one
        svc._pack_one = lambda i, host, j, idr: (
            pack(i, host, j, idr) if idr else flip(pack(i, host, j, idr)))
        return
    enc = entry.enc
    if hasattr(enc, "_step_p"):        # the band- or tile-sliced encoder
        complete = enc.complete_frame

        def completed(pending):
            au = complete(pending)
            return au if pending.idr else flip(au)

        enc.complete_frame = completed
        return
    emit = enc._emit

    def emitted(rec):
        au, st, meta = emit(rec)
        return (au if st.idr else flip(au)), st, meta

    enc._emit = emitted


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "altered": altered}
APPLIES = {"state_unchanged": ("session_service", "solo_row", "tile_grid_row"),
           "half_batch": ("session_service",),     # one session has no half
           "altered": ("session_service", "solo_row", "tile_grid_row")}

"""Checked capacities: one-program frames whose list sizes depend on the
data (the high-poly route: the compact setup, kernels B3 and B4).

lsr_tpu traces these frames with fixed capacities and reports an overflow
as a stat (lsr_tpu/passes/standard_passes.py:93-107): its fixed B3 list cap
drops triangles, and its compact setup drops rows when a cap is exceeded.
The port never drops a triangle, and eagerly it sizes each list from the
data on the host in mid-frame, which a captured frame cannot do.  So a
frame takes its capacities as a frozen host value known before the frame
(Capacities, part of jit's key), reads nothing on the host, and returns
lsr_tpu's stats as device values with one flag, raster_stats
["capacity_exceeded"], set where a capacity was exceeded.  checked(fn)
reads that flag once after the frame; when it is set, the capacities grow
to what the frame's stats say it needed and the frame runs again eagerly
(as the warm-up of the new key, which captures on its next call), so a
frame that dropped a triangle is never returned, the capture call's
included.  Each key of a call (a scene, a target size) has capacities of
its own, which never shrink.  A camera's zn / zf are data (tensors), not
part of the key: a zn whose frame overflows its key's capacities sets the
flag, is redone eagerly and grows them, as any other overflow.

The stats a frame returns (device values unless noted):
- raster_max_bin: B3's largest bin before capping;
- raster_pairs: the (row, tile) pairs B3's lists are built from;
- compact_overflow: scene_setup_compact dropped rows (when it ran);
- raster_cap_used, compact_fallback: host values, what the capacities said
  (what the eager route read);
- capacity_exceeded: the flag (absent where no capacity was involved: the
  B1 route, whose lists have static shapes).

None of them is sized from the worst case: B3's lists at 1080p would take
(255, ~700K) i32, about 0.7 GB.  B4's worklists and B1's super lists are
built from dense masks with static shapes, as lsr_tpu builds them, and
need no capacity.
"""

from __future__ import annotations

import collections
import dataclasses

from lsr_tpu_torch.raster import tiled
from lsr_tpu_torch.raster.tiled import fitted_cap
from lsr_tpu_torch.utils import trace
from lsr_tpu_torch.utils.jit import MAX_GRAPHS, jit, trace_key


def next_pow2(n: int) -> int:
    """The smallest power of two >= max(n, 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Capacities:
    """What a frame may not read on the host: B3's list width (kept to
    tiled.fitted_cap's rule: a multiple of 256 and at least the frame's
    raster_cap), the pair slots of bin_triangles' capacity route, and
    whether scene_setup_compact is used above the compact threshold."""

    list_width: int = 0
    pairs: int = 0
    compact: bool = True

    @classmethod
    def sized(cls, stats) -> "Capacities":
        """The capacities an eager frame's raster_stats show it needed (host
        reads at the end of the frame)."""
        stats = stats or {}
        pairs = stats.get("raster_pairs")
        return cls(list_width=int(stats.get("raster_cap_used", 0)),
                   pairs=0 if pairs is None else next_pow2(int(pairs)),
                   compact=not stats.get("compact_fallback", False))

    def grown(self, stats) -> "Capacities":
        """These capacities grown to what a frame's raster_stats show it
        needed: the list width by fitted_cap, the pairs to the next power of
        two, the full setup after a compact overflow."""
        stats = stats or {}
        width, pairs, compact = self.list_width, self.pairs, self.compact
        if "raster_max_bin" in stats:
            width = fitted_cap(width, int(stats["raster_max_bin"]))
        if "raster_pairs" in stats:
            pairs = max(pairs, next_pow2(int(stats["raster_pairs"])))
        if "compact_overflow" in stats:
            compact = compact and not bool(stats["compact_overflow"])
        return Capacities(width, pairs, compact)


def binned_raster(setup, width: int, height: int, zn, zf,
                  caps: Capacities | None, cap: int, tile_h: int,
                  tile_w: int, chunk: int):
    """Kernel B3 (tiled.rasterize_tiled) with a list width of at least
    `cap`: caps=None fits it to the largest bin (the eager route, a host
    read), otherwise caps' width and pair slots (no host read).  Returns
    (depth, tid, stats): raster_cap_used, raster_max_bin, raster_pairs,
    and with caps the flag capacity_exceeded."""
    kw = dict(tile_h=tile_h, tile_w=tile_w, chunk=chunk)
    if caps is None:
        depth, tid, max_bin, pairs, _ = tiled.rasterize_tiled(
            setup, width, height, zn, zf, cap=cap, fit_cap=True, **kw)
        stats = {"raster_cap_used": fitted_cap(cap, int(max_bin))}
    else:
        used = fitted_cap(cap, caps.list_width)
        depth, tid, max_bin, pairs, over = tiled.rasterize_tiled(
            setup, width, height, zn, zf, cap=used, pairs=caps.pairs, **kw)
        stats = {"raster_cap_used": used, "capacity_exceeded": over}
    stats["raster_max_bin"] = max_bin
    stats["raster_pairs"] = pairs
    return depth, tid, stats


def exceeded(stats) -> bool:
    """The frame's flag, read on the host (one sync); False where the frame
    involved no capacity."""
    flag = (stats or {}).get("capacity_exceeded")
    return flag is not None and bool(flag)


class Checked:
    """checked(fn): fn(*args, caps) -> (out, raster_stats) as one program
    with checked capacities; calling it with *args returns out.

    Capacities are kept per key: caps maps key(*args) (jit's key of the
    call, without the capacities) to the call's Capacities, for at most
    MAX_GRAPHS keys, least recently used first, so a scene or a target
    size each has its own and one never sizes another (zn / zf, tensors,
    share their key's).
    A key's first call runs fn(*args, None), the eager route that sizes its
    lists on the host, and keeps Capacities.sized of its stats.  Every
    later call runs jit(fn)(*args, caps) (warm-up, capture, replays, as
    utils.jit does) and reads the flag once after it (the span
    checked.flag, with tracing on).  When it is set the
    key's capacities grow (growths), its stale graph is released and the
    frame runs again eagerly at the new capacities as the new key's
    warm-up (retries counts such frames), until no flag is set.  The
    launch counters count what ran: a redone frame's launches twice."""

    def __init__(self, fn, name=None):
        self.fn = fn
        self.jitted = jit(fn, name)
        self.caps: collections.OrderedDict = collections.OrderedDict()
        self.growths = self.retries = 0

    @property
    def captures(self) -> int:
        return self.jitted.captures

    @staticmethod
    def key(*args):
        """The key a call's capacities are kept under."""
        return trace_key(args)[0]

    def __call__(self, *args):
        key = self.key(*args)
        caps = self.caps.pop(key, None)
        if caps is None:
            out, stats = self.fn(*args, None)
            caps = Capacities.sized(stats)
        else:
            out, stats = self.jitted(*args, caps)
            with trace.span("checked.flag"):
                over = exceeded(stats)
            self.retries += over
            while over:
                grown = caps.grown(stats)
                if grown == caps:
                    raise RuntimeError(f"{self.jitted.name}: a capacity was "
                                       f"exceeded, but the stats name none")
                self.jitted.forget(*args, caps)
                caps = grown
                self.growths += 1
                out, stats = self.jitted.warm_up(*args, caps)
                over = exceeded(stats)
        self.caps[key] = caps
        while len(self.caps) > MAX_GRAPHS:
            self.caps.popitem(last=False)
        return out


def checked(fn, name=None) -> Checked:
    """fn(*args, caps) -> (out, raster_stats) as a checked one-program
    frame (see Checked)."""
    return Checked(fn, name)

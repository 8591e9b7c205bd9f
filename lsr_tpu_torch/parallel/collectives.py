"""The collectives of the port's meshes: plain functions over per-rank lists.

lsr_tpu runs one program per rank under shard_map and exchanges data with
lax collectives inside it.  The port keeps the single-controller model:
a step runs each rank's work in rank order, on that rank's device, and
splits it at each collective.  A collective takes the ranks' parts of one
mesh axis, in rank order, as a list of tensors (part r on rank r's device)
and returns the list each rank receives, every entry on its receiver's
device (devices: the receivers' devices, in rank order).  Nothing here
uses torch.distributed: a part moves to another device with Tensor.to,
which is a no-op when the ranks share one device.  There every collective
is device work alone (a concatenation, a fill, a sum), with no host read
or copy, so a step whose ranks share one card stays capturable as one
CUDA graph (utils.jit).

  all_gather  lax.all_gather(x, axis, axis=0, tiled=True)
  ppermute    lax.ppermute(x, axis, perm)
  psum        lax.psum(x, axis)
"""

from __future__ import annotations

import torch


def all_gather(parts, devices):
    """Every rank receives the concatenation of all ranks' parts along
    dim 0, in rank order, on its own device."""
    return [torch.cat([p.to(d) for p in parts]) for d in devices]


def ppermute(parts, perm, devices):
    """perm: (source, destination) rank pairs, each rank a destination at
    most once.  Rank dst receives parts[src] on its device; a rank that
    receives nothing gets zeros of its own part's shape and type, as in
    JAX."""
    out = [torch.zeros_like(p, device=d) for p, d in zip(parts, devices)]
    dests = [dst for _, dst in perm]
    if len(set(dests)) != len(dests):
        raise ValueError(f"ppermute: a rank receives twice in {perm}")
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst])
    return out


def psum(parts, devices):
    """The sum of all ranks' parts, added in rank order (((p0 + p1) + p2)
    + ...), on each of `devices`: every rank's device for lax.psum, one
    device where only that rank reads the sum."""
    out = []
    for d in devices:
        acc = parts[0].to(d)
        for p in parts[1:]:
            acc = acc + p.to(d)
        out.append(acc)
    return out

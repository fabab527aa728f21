"""Run a reference's period over K recorded periods.

``period(state, inputs) -> outputs`` reads the period's recorded inputs,
advances ``state`` (a dict of tensors, in place) and returns a tuple of
tensors.  On a GPU the period is captured once as a CUDA graph and
replayed, so a reference of a few hundred small operations a period costs
the device's time and not the host's; on the CPU it runs eagerly.  The
arithmetic is the same either way.
"""
from __future__ import annotations

import torch


def run(period, state, seq):
    """Stacked outputs over the K periods of ``seq`` (tensors (K, ...))."""
    K = seq[0].shape[0]
    if seq[0].device.type != "cuda":
        outs = [period(state, [s[k] for s in seq]) for k in range(K)]
        return tuple(torch.stack(o) for o in zip(*outs))
    slots = [s[0].clone() for s in seq]
    start = {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            period(state, slots)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = period(state, slots)
    for k, v in start.items():
        state[k].copy_(v)
    outs = [torch.empty((K,) + r.shape, dtype=r.dtype, device=r.device) for r in res]
    for k in range(K):
        for slot, s in zip(slots, seq):
            slot.copy_(s[k])
        graph.replay()
        for o, r in zip(outs, res):
            o[k].copy_(r)
    torch.cuda.synchronize()
    return tuple(outs)

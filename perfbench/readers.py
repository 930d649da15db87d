"""The reading each per-layer quantity takes from a traced window's context
(`loops.trace_ctx`), shared by the reader files of
`perfbench/metrics/<quantity>.<cells>.py`, which declare the layer, unit,
source and the end-to-end metric each moves.  A reader returns None where
the window holds nothing to read."""
from __future__ import annotations

from perfbench.yardstick import BF16_TENSOR_FLOPS


def device_idle_pct(ctx):
    """The share of the traced window in which no operation ran on the
    device (1 - busy / window), averaged over the GPUs used, in percent."""
    if ctx["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx["busy_s"] / ctx["window_s"])


def hand_kernels_roofline(ctx):
    """The hand kernels' summed roofline bound over their summed device
    time, in percent.  The bound of each launch in the traced window comes
    from the benchmark's frozen work counts on that launch's own inputs
    (bytes once, distinct table points) and the H100's data-sheet peaks
    (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32); on several GPUs,
    rank 0's."""
    t = sum(b - a for name, a, b in ctx["device_ops"]
            if any(p in name for p in ctx["hand"])) * 1e-6
    if t <= 0 or ctx["bound_s"] <= 0:
        return None
    return 100.0 * ctx["bound_s"] / t


def step_mfu(ctx):
    """The model's operations on the window's samples (the encode's
    interpolation and both MLPs, forward, and in training their backward)
    over the traced window's seconds, the GPUs used and the H100's 989
    TFLOP/s bf16 peak, in percent."""
    if not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["chips"]
                                   * BF16_TENSOR_FLOPS)


def torch_kernels_ms(ctx):
    """Device milliseconds a step or frame of every kernel, copy and fill
    that is neither a hand kernel nor a collective: the PyTorch glue."""
    ops = [op for op in ctx["device_ops"]
           if not any(p in op[0] for p in ctx["hand"] + ctx["comm"])]
    if not ops:
        return None
    return sum(b - a for _, a, b in ops) * 1e-3 / ctx["units"]

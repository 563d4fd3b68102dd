"""W8's share of its roofline in the traced slice: the least time the card
could take for the W8 calls counted while it recorded (each at the (M, K, N)
its wrapper gave the kernel library, ``sstw_dense_w8`` or
``sstw_logits_w8``; a graph replay counts its capture's calls) over W8's
device time in the trace (``dense_w8_kernel``, every instance). The least
time (``bounds.bound``) reads the int8 weight, the fp32 scales, the bf16
bias of a dense product (every int8 dense of an unsharded model has one),
the bf16 x and writes the output (bf16 dense, fp32 logits) once, against
2 M N K bf16 operations. A program without W8 counts no such call: no
value."""

from benchmark import bounds, devtrace

TRACE_NAME = "dense_w8_kernel"
OUT_BYTES = {"sstw_dense_w8": 2, "sstw_logits_w8": 4}


def work(fn: str, m: int, k: int, n: int) -> tuple:
    bias = 2 * n if fn == "sstw_dense_w8" else 0
    n_bytes = k * n + 4 * n + bias + 2 * m * k + OUT_BYTES[fn] * m * n
    return n_bytes, {"bf16": 2 * m * n * k}


def read(view):
    if view.trace is None:
        return None
    least = sum(count * bounds.bound(*work(fn, *ints))[0]
                for (fn, ints), count in view.trace.calls.items() if fn in OUT_BYTES)
    spent = devtrace.kernel_seconds(view.trace, TRACE_NAME)
    return 100.0 * least / spent if least > 0 and spent > 0 else None

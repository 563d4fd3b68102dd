"""Process start to the first request of the window: imports, the kernel
library's load (its build in a fresh checkout), the weights, ``warmup()``
and the cell's warm-up requests."""


def read(view):
    return view.setup_s

"""``setup_s``: seconds from the process's start to the window's first
timed call (host clock): imports, the CUDA context, the kernel library
(built by nvcc on a checkout's first run), the integrators and set-up's
call or steps at the cell's own shape."""


def read(rec):
    return rec["setup_s"]

"""setup_s: seconds from the process's start to the first timed pass:
imports, the CUDA context, loading or building the kernel libraries, the
histogram's allocation and the warm-up passes."""


def read(m):
    return m.setup_s

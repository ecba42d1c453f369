"""setup_s: seconds from process start to the first timed call (imports,
CUDA start, the native and kernel libraries from their caches, the inputs
from the seed, one warm call on the full inputs); host clock."""


def read(run):
    return run.setup_s

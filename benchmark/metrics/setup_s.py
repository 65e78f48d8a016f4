"""setup_s: process start to the window's start (imports, the inputs
from the seed, the kernel libraries, the warm fit), in s."""


def read(ctx):
    return ctx["setup_s"]

"""Device: 100 x (1 - the union of kernel and copy intervals over the
traced window)."""

from kserbench.harness import layers as L


def read(run):
    return L.idle_pct(run)

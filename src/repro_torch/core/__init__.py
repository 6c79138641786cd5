"""Numpy control plane of the port: graphs, MST, coloring, slot plans and
their lowering to permutation steps (trimmed copies of ``repro.core``)."""

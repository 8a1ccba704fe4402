"""Hand-written GPU kernels (Pallas, Triton route).

Each kernel has a plain XLA counterpart that stays the semantic reference
and the path on other backends; see ops/trace.resolve_intersector.
"""

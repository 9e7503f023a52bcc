"""FlexNN core, ported: the access-count energy model and the per-layer
schedule search, the descriptor table and matmul schedule selector,
FlexTree's cycle models and its mesh combine (``reduce_psum``), the §V-C
sparsity profiles, and the sparsity machinery (ZVC codec, CSB,
weight-sparsity plans)."""

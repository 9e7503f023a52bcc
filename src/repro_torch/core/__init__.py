"""FlexNN core, ported: descriptor table, schedule selector, FlexTree's
analytic half and the weight-sparsity plan layer."""

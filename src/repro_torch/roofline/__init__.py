"""The roofline of the production cells: the memory tracker of a traced
step (``memory``), the per-cell analysis (``analysis``) and the knob
hillclimb over it (``hillclimb``)."""

"""Cost, memory and roofline of a traced step (port of
``repro.analysis``): :mod:`~repro_torch.analysis.cost` counts a step's
flops, HBM bytes and device ops and tracks its live memory;
:mod:`~repro_torch.analysis.roofline` turns the counts into the H100's
compute and memory terms."""

"""The paper's figures on the port's closed-form simulator.

One module per figure script of the JAX package's benchmarks, with the
same configuration, grids, steps and full trial counts.  Each module's
``run(device="cuda", smoke=False)`` draws its own problem and batches
from seeded ``torch.Generator``s on ``device``, returns the figure's
payload (the frontier rows and the ``claims``) and, at full trials,
asserts the claims.  Nothing is written to disk; ``chip_smoke.py``
records the payloads.

* :mod:`.fig1_right` — gain trigger vs the gradient-norm baseline;
* :mod:`.fig2_left` — the communication/performance trade-off over λ;
* :mod:`.fig2_right` — exact (eq. 28) vs estimated (eq. 30) gain;
* :mod:`.lambda_decay` — diminishing-λ schedules;
* :mod:`.theory_bounds` — Theorem 1 / Theorem 2 against measured runs.
"""

FIGURES = ("fig1_right", "fig2_left", "fig2_right", "lambda_decay",
           "theory_bounds")


def seeded(seed: int, device) -> "torch.Generator":
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    import torch

    from repro_torch.utils.device import resolve_device

    return torch.Generator(device=resolve_device(device)).manual_seed(seed)

"""The paper's own experimental configurations (Section 4), plus the
beyond-paper tiered-network scenario layer — a copy of
``repro.configs.paper_linreg`` (pure dataclasses, so the two packages
describe every fleet identically), plus the quadratic-gated tier mix the
port's first slice serves (:data:`TIERED_M64_QUADRATIC`).
"""
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class LinRegConfig:
    name: str
    n: int                      # feature dimension
    num_agents: int             # m
    samples_per_agent: int      # N, fresh i.i.d. per iteration per agent
    stepsize: float             # ε
    steps: int                  # K
    noise_std: float = 1.0      # η std
    cov_diag: Tuple[float, ...] = ()   # diag(E xx^T); () -> random diag
    cov_range: Tuple[float, float] = (0.5, 3.0)  # random-diag draw range
    w_star: Tuple[float, ...] = ()     # true weights; () -> random
    w0_scale: float = 0.0              # w0 = w0_scale * ones


# Fig 2 (Left): λ-sweep tradeoff. n=2, cov=diag(3,1), w*=(3,5), w0=0,
# eps=0.1, N=5, K=10, m=2.
FIG2_LEFT = LinRegConfig(
    name="fig2_left", n=2, num_agents=2, samples_per_agent=5,
    stepsize=0.1, steps=10, cov_diag=(3.0, 1.0), w_star=(3.0, 5.0),
)

# Fig 2 (Right): exact (28) vs estimated (30) gain. Same setup, eps=0.2,
# single time step.
FIG2_RIGHT = LinRegConfig(
    name="fig2_right", n=2, num_agents=2, samples_per_agent=5,
    stepsize=0.2, steps=1, cov_diag=(3.0, 1.0), w_star=(3.0, 5.0),
)

# Fig 1 (Right): gain trigger vs grad-norm trigger. n=10, random diag cov
# ("randomly chosen coefficients" — drawn anisotropic: the paper notes the
# gap grows when the Hessian is far from identity), random w*, N=20,
# eps=0.2, K=10.
FIG1_RIGHT = LinRegConfig(
    name="fig1_right", n=10, num_agents=2, samples_per_agent=20,
    stepsize=0.2, steps=10, cov_range=(0.1, 5.0),
)

# Beyond-paper heterogeneous network (ROADMAP): m=8 agents on MIXED
# per-agent comm policies (dense backbone + gated/compressed edge tiers),
# exercising the stage-bank dispatch and the wire-byte
# frontier at a scale the paper never ran.
HETERO_M8 = LinRegConfig(
    name="hetero_m8", n=32, num_agents=8, samples_per_agent=64,
    stepsize=0.05, steps=40, cov_range=(0.2, 4.0),
)


# ----------------------------------------------------------------------
# Tiered-network scenarios (m ≥ 64)
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class TierSpec:
    """One bandwidth tier of a tiered network.

    ``policy`` is a ``repro_torch.comm`` spec-string *template*: an optional
    ``{lam}`` placeholder receives ``lam_base × lam_mult`` when the
    network is instantiated, so one scenario spans a whole λ family.
    ``wire_budget`` is the tier's uplink allowance in effective bytes
    per agent per round (the dense fp32 payload is ``4n`` bytes) —
    scenario metadata the benchmarks check frontiers against, not a
    constraint enforced during training.
    """

    name: str
    count: int
    policy: str
    lam_mult: float = 1.0
    wire_budget: float = float("inf")

    def spec(self, lam_base: float) -> str:
        if "{lam}" not in self.policy:
            return self.policy
        return self.policy.format(lam=repr(lam_base * self.lam_mult))


@dataclass(frozen=True)
class TieredNetwork:
    """A named tier mix: the per-agent policy layout of a large fleet."""

    name: str
    tiers: Tuple[TierSpec, ...]

    @property
    def num_agents(self) -> int:
        return sum(t.count for t in self.tiers)

    def policies(self, lam_base: float = 1.0) -> Tuple[str, ...]:
        """The per-agent spec tuple (tier order, tier-contiguous)."""
        return tuple(
            t.spec(lam_base) for t in self.tiers for _ in range(t.count)
        )

    def tier_index(self) -> Tuple[int, ...]:
        """Agent → tier id (index into ``tiers``)."""
        return tuple(i for i, t in enumerate(self.tiers) for _ in range(t.count))

    def budgets(self) -> Tuple[float, ...]:
        """Per-agent wire budgets (bytes/round), tier-expanded."""
        return tuple(t.wire_budget for t in self.tiers for _ in range(t.count))


def _tiers(backbone: int, metro: int, edge: int, sensor: int, n: int = 32
           ) -> Tuple[TierSpec, ...]:
    """The four-tier smart-city template over an n-feature model.

    Dense fp32 payload is 4n bytes/round.  Budgets taper with the tier
    and are set BELOW each tier's always-transmit wire rate (fp16 every
    round is 0.5×dense, int8 0.25×, topk(0.05)|int8 0.0625×), so a
    metered tier only fits its uplink once its trigger actually gates —
    the frontier has to *cross into* feasibility, it doesn't start
    there.  λ tightens as budgets shrink (harder gating where bytes are
    scarce), the coupling arXiv:2101.10007 schedules adaptively.
    """
    dense = 4.0 * n
    return (
        TierSpec("backbone", backbone, "always"),
        TierSpec("metro", metro, "gain_lookahead(lam={lam})|fp16",
                 lam_mult=1.0, wire_budget=0.35 * dense),
        TierSpec("edge", edge, "gain_lookahead(lam={lam})|int8+ef",
                 lam_mult=2.0, wire_budget=0.15 * dense),
        TierSpec("sensor", sensor,
                 "gain_lookahead(lam={lam})|topk(0.05)|int8+ef",
                 lam_mult=4.0, wire_budget=0.04 * dense),
    )


# The m=8 pathfinder fleet (benchmarks/hetero_frontier.py): the same
# four-tier template at m=8 — one source of truth
# for the tier layout, so the m=8 and m=64 artifacts cannot drift apart.
HETERO_M8_NET = TieredNetwork("hetero_m8", _tiers(2, 2, 2, 2))

# The m=64 scenario family: one fleet size, three tier mixes, so a
# frontier can compare WHERE the agents sit, not just how hard they
# gate.  All mixes share the four-tier template (4 distinct policies →
# the stage bank compiles 4 branches regardless of mix).
TIERED_M64 = TieredNetwork("tiered_m64", _tiers(8, 16, 24, 16))
TIERED_M64_EDGE_HEAVY = TieredNetwork(
    "tiered_m64_edge_heavy", _tiers(2, 6, 24, 32)
)
TIERED_M64_BACKBONE_HEAVY = TieredNetwork(
    "tiered_m64_backbone_heavy", _tiers(24, 24, 12, 4)
)
# the ragged stress mix: ONE policy owns ~90% of the fleet (58/64
# sensors).  A padded per-branch epilogue layout would force the three
# small branches to materialize 58-row buffers of duplicated agents;
# the sort-by-policy blocked dispatch keeps every branch exactly sized.
TIERED_M64_ONE_BIG = TieredNetwork(
    "tiered_m64_one_big", _tiers(2, 2, 2, 58)
)

TIER_MIXES: Tuple[TieredNetwork, ...] = (
    TIERED_M64, TIERED_M64_EDGE_HEAVY, TIERED_M64_BACKBONE_HEAVY,
    TIERED_M64_ONE_BIG,
)

# The linreg problem the m=64 frontiers run on (same data model as
# HETERO_M8, eight times the fleet).
TIERED_M64_CFG = LinRegConfig(
    name="tiered_m64", n=32, num_agents=64, samples_per_agent=32,
    stepsize=0.05, steps=40, cov_range=(0.2, 4.0),
)


# ----------------------------------------------------------------------
# Budget-adaptive tier mix (closed-loop scheduling, arXiv:2101.10007)
# ----------------------------------------------------------------------

def _adaptive_tiers(backbone: int, metro: int, edge: int, sensor: int,
                    n: int = 32) -> Tuple[TierSpec, ...]:
    """The smart-city template with CLOSED-LOOP metered tiers.

    Same tier layout, wire formats and per-tier budgets as
    :func:`_tiers`, but each metered tier's trigger is a budget
    controller TARGETING its own ``wire_budget`` instead of a hand-tuned
    fixed λ: the metro tier runs ``budget_window`` on the byte budget
    directly, the edge/sensor tiers run ``budget_dual`` on the
    equivalent transmit rate ``budget / (dense × chain ratio)``.  The
    budgets still sit BELOW each tier's always-transmit rate, so the
    controllers must gate their way into feasibility — and, unlike the
    fixed-λ template, they keep tracking the budget as the gain
    distribution drifts over training.
    """
    dense = 4.0 * n
    metro_budget = 0.35 * dense
    edge_budget = 0.15 * dense
    sensor_budget = 0.04 * dense
    # per-transmission wire cost per tier: dense payload × chain ratio
    # (fp16 = 0.5, int8 = 0.25, topk(0.05)|int8 = 0.0625 — DESIGN.md §2)
    edge_rate = edge_budget / (0.25 * dense)
    sensor_rate = sensor_budget / (0.0625 * dense)
    return (
        TierSpec("backbone", backbone, "always"),
        TierSpec("metro", metro,
                 f"budget_window(bytes={metro_budget!r})|fp16",
                 wire_budget=metro_budget),
        TierSpec("edge", edge,
                 f"budget_dual(rate={edge_rate!r})|int8+ef",
                 wire_budget=edge_budget),
        TierSpec("sensor", sensor,
                 f"budget_dual(rate={sensor_rate!r})|topk(0.05)|int8+ef",
                 wire_budget=sensor_budget),
    )


# The adaptive counterpart of TIERED_M64: identical fleet layout and
# budgets, controllers instead of hand-tuned λs — the pairing
# benchmarks/adaptive_budget.py publishes.
TIERED_M64_ADAPTIVE = TieredNetwork(
    "tiered_m64_adaptive", _adaptive_tiers(8, 16, 24, 16)
)


# ----------------------------------------------------------------------
# Lossy-channel tier mixes (repro.net, benchmarks/lossy_channels.py)
# ----------------------------------------------------------------------

def _lossy(net: TieredNetwork, name: str, channel: str,
           skip: Tuple[str, ...] = ("backbone",)) -> TieredNetwork:
    """Attach an ``@ channel`` suffix to a network's metered tiers.

    The backbone tier keeps its ideal wire by default (fibre links —
    and keeping ONE lossless always-transmit tier guarantees eq. (10)'s
    denominator never empties even at high loss severity).  The other
    tiers share one channel model, so the stage bank still dedupes to
    four branches.
    """
    tiers = tuple(
        t if t.name in skip else replace(t, policy=f"{t.policy} @ {channel}")
        for t in net.tiers
    )
    return TieredNetwork(name, tiers)


# The lossy m=64 pairing benchmarks/lossy_channels.py publishes: the
# SAME fleet layouts and per-tier budgets as TIERED_M64 /
# TIERED_M64_ADAPTIVE, with 20% Bernoulli loss on every metered tier.
# The fixed-λ mix was hand-tuned for an ideal wire, so under loss it
# either starves (EF folds drops back but the gate never re-opens) or
# violates its DELIVERED-byte budget; the adaptive mix prices delivered
# bytes (repro.comm.triggers) and re-gates toward the same budgets.
LOSSY_CHANNEL = "bernoulli(p=0.2,boost=0.05)"
TIERED_M64_LOSSY = _lossy(TIERED_M64, "tiered_m64_lossy", LOSSY_CHANNEL)
TIERED_M64_ADAPTIVE_LOSSY = _lossy(
    TIERED_M64_ADAPTIVE, "tiered_m64_adaptive_lossy", LOSSY_CHANNEL
)


# ----------------------------------------------------------------------
# Latency tier mixes + scenario churn (benchmarks/async_rounds.py)
# ----------------------------------------------------------------------

# The async m=64 pairing: SAME fleet layouts and budgets, with a
# geometric-latency wire (mean lag 2 rounds, FIFO depth 6) on every
# metered tier.  DELAY_CHANNEL discounts stale payloads at application
# (w = 1 / (1 + 0.5·(age−1))); DELAY_CHANNEL_NAIVE is the identical
# wire with discount=0 — apply-on-arrival at full weight, the ablation
# benchmarks/async_rounds.py compares at equal wire bytes.
DELAY_CHANNEL = "delay(dist=geometric,lag=2.0,max_lag=6,discount=0.5)"
DELAY_CHANNEL_NAIVE = "delay(dist=geometric,lag=2.0,max_lag=6)"
TIERED_M64_DELAYED = _lossy(
    TIERED_M64, "tiered_m64_delayed", DELAY_CHANNEL
)
TIERED_M64_ADAPTIVE_DELAYED = _lossy(
    TIERED_M64_ADAPTIVE, "tiered_m64_adaptive_delayed", DELAY_CHANNEL
)
TIERED_M64_DELAYED_NAIVE = _lossy(
    TIERED_M64, "tiered_m64_delayed_naive", DELAY_CHANNEL_NAIVE
)


def churn_schedule(net: TieredNetwork, steps: int, *, period: int = 4,
                   skip: Tuple[str, ...] = ("backbone",)
                   ) -> Tuple[Tuple[int, int], ...]:
    """A deterministic per-agent ``(join, leave)`` activity schedule.

    Within each metered tier, every ``period``-th agent (offset 1)
    JOINS late — at ``steps // 4`` — and every ``period``-th (offset 2)
    LEAVES early — at ``3·steps // 4``; everyone else, and every tier
    in ``skip`` (the backbone, by default), is up for the whole run.
    Roughly ``2/period`` of the metered fleet churns, the scenario
    ``StepOptions(churn=...)`` and the rollup's active-agent-round
    denominators are tested against.  Tier-contiguous agent order
    matches :meth:`TieredNetwork.policies`.
    """
    late = max(steps // 4, 1)
    early = max((3 * steps) // 4, late + 1)
    sched = []
    for t in net.tiers:
        for j in range(t.count):
            if t.name in skip:
                sched.append((0, steps))
            elif j % period == 1:
                sched.append((late, steps))
            elif j % period == 2:
                sched.append((0, early))
            else:
                sched.append((0, steps))
    return tuple(sched)


# ----------------------------------------------------------------------
# Quadratic-gated tier mix (the paper's eq. 28 trigger on the fleet)
# ----------------------------------------------------------------------

def _quadratic(net: TieredNetwork, name: str) -> TieredNetwork:
    """Swap a network's lookahead gates for ``gain_quadratic`` with the
    fused ``gain_reduce`` kernel (``kernel=true``).

    Same tiers, counts, λ multipliers, wire formats and budgets; every
    metered tier gates on eq. (28) ``−ε gᵀg + ½ε² gᵀHg`` instead of the
    lookahead probe.  The three metered tiers share one prologue (the
    HVP plus one batched kernel call over all agents per round).
    """
    lookahead = "gain_lookahead(lam={lam})"
    quadratic = "gain_quadratic(lam={lam},kernel=true)"
    return TieredNetwork(name, tuple(
        replace(t, policy=t.policy.replace(lookahead, quadratic))
        for t in net.tiers
    ))


# TIERED_M64's layout with its metered tiers gated by eq. (28) through
# the gain_reduce kernel — the fleet the port serves on the card.
TIERED_M64_QUADRATIC = _quadratic(TIERED_M64, "tiered_m64_quadratic")

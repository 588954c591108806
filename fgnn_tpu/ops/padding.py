"""Static-shape planning.

XLA requires static shapes; every reference stage instead produces
data-dependent sizes (num_sample, num_unique, num_miss). This module is
the static-shape answer: the analog of ``PredictNumNodes`` (reference common.h:244-250)
computes *padded maxima* per layer once at trace time; all kernels then work
on fixed-size buffers with ``-1`` (EMPTY_KEY) padding masks.

Worst-case caps explode multiplicatively with fanout, so like the
reference's 1.25x workspace scale (constant.h:78) we support an optional
measured `scale` to cap buffers near observed unique counts; overflow is
detected at runtime (sampler reports a clipped flag) rather than crashing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from .. import constants


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


def _bucket_up(x: int, steps_per_octave: int) -> int:
    """Round up to a coarse geometric grid (128 * 2^(i/steps)).

    Compile-time shape bucketing: measured caps differ slightly across
    nearby configs (seed, skew, calibration probes), and every distinct
    cap is a distinct XLA program. Bucketing trades bounded padding overhead (<= 2^(1/steps)-1,
    e.g. 19% at 4 steps/octave, 9% at 8) for program reuse."""
    import math

    if x <= 128:
        return 128
    i = math.ceil(math.log2(x / 128.0) * steps_per_octave - 1e-9)
    return _round_up(int(math.ceil(128.0 * 2.0 ** (i / steps_per_octave))))


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """Per-layer static buffer sizes for one mini-batch sample.

    Layer order is sampling order: layer 0 seeds are the training batch,
    hop l uses ``fanouts[l]`` (the reference iterates fanouts deepest-first,
    cuda_loops.cc:87-257; we store them already in sampling order).
    """

    batch_size: int
    fanouts: Tuple[int, ...]           # in sampling order (seed hop first)
    num_input_cap: Tuple[int, ...]     # cap on input (seed) count per hop
    num_edge_cap: Tuple[int, ...]      # cap on sampled edges per hop
    num_unique_cap: Tuple[int, ...]    # cap on unique output per hop
    # degree-tiered LAST hop (no-dedup fast mode only): the frontier is
    # partitioned by degree into tiers of DESCENDING slot width — tier 0
    # Floyd-samples at the full fanout (vertices with deg above the next
    # tier's width), every lower tier takes ALL its <= width neighbors
    # (distribution-identical for uniform-without-replacement). Cuts
    # edge-slot padding (a flat V*fanout cap is ~33%-occupied at bench
    # shapes) and with it the CSR/feature gathers of every padded slot.
    # ``tier_layout`` is a tuple of
    # (vertex_cap, slot_width) pairs, caps summing to the frontier cap.
    tier_layout: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def tier_a_cap(self) -> Optional[int]:
        return self.tier_layout[0][0] if self.tier_layout else None

    @property
    def tier_b_fanout(self) -> Optional[int]:
        return self.tier_layout[-1][1] if self.tier_layout else None

    @property
    def num_layer(self) -> int:
        return len(self.fanouts)

    @property
    def final_input_cap(self) -> int:
        """Cap on |input_nodes| of the whole batch (feature-gather size)."""
        return self.num_unique_cap[-1]


def make_plan(
    batch_size: int,
    fanouts: Sequence[int],
    num_node: int,
    scale: float = constants.ALLOC_SCALE,
    unique_caps: Optional[Sequence[int]] = None,
    tier_stats: Optional[dict] = None,
) -> SamplePlan:
    """Compute padded sizes.

    ``fanouts`` is given in config order (reference passes [5,10,15] and
    samples with 15 first, cuda_loops.cc:92); we reverse into sampling
    order here so plan.fanouts[0] applies to the training batch.

    ``unique_caps`` optionally overrides the worst-case per-hop unique
    caps with measured values (already in sampling order).

    ``FGNN_TPU_ALLOC_SCALE`` overrides ``scale`` (e.g. the multichip
    dryrun sets a generous scale so its correctness signal is never
    computed on clipped neighborhoods).

    ``FGNN_TPU_CAP_BUCKET=<steps/octave>`` (opt-in) rounds measured caps
    up to a coarse geometric grid so nearby configs share compiled
    programs; 0/unset keeps exact
    128-aligned caps.
    """
    import os

    scale = float(os.environ.get("FGNN_TPU_ALLOC_SCALE", scale))
    bucket = int(os.environ.get("FGNN_TPU_CAP_BUCKET", "0"))
    fan = tuple(reversed([int(f) for f in fanouts]))
    n_in = []
    n_edge = []
    n_uniq = []
    cur = _round_up(batch_size)
    for l, f in enumerate(fan):
        n_in.append(cur)
        edges = cur * f
        n_edge.append(edges)
        # The unique buffer layout is [static seed block | appended new
        # nodes] (ops/hashtable.py contract: seeds keep their input
        # positions). Capacity must therefore cover the STATIC seed slots
        # plus the measured/worst-case APPEND count — clamping the total
        # at num_node left zero append room once the frontier cap
        # saturated the graph, and every batch clipped (fig17a round-4).
        if unique_caps is not None:
            uc = unique_caps[l]
            if isinstance(uc, tuple):
                _, new = uc
                uniq = cur + _round_up(int(new * scale))
            else:                               # legacy cumulative int
                uniq = max(_round_up(int(uc * scale)), cur + 128)
            if bucket > 0:
                uniq = _bucket_up(uniq, bucket)
        else:
            uniq = _round_up(cur + edges)      # worst case: all new
        # at most num_node NEW nodes can ever be appended
        uniq = min(uniq, _round_up(cur + num_node))
        n_uniq.append(uniq)
        cur = uniq

    # --- degree-tiered last hop (see SamplePlan.tier_layout) -----------
    # tier_stats: {t: [per-probe count(frontier deg > t)]} measured by
    # calibrate_caps. Search threshold subsets (up to 3 take-all tiers
    # below the Floyd tier) minimizing total slots, margining every
    # tier-prefix cap with max-plus-range + scale like the other caps;
    # only engage when it saves >= 10% of the flat cap — below that the
    # partition sort + unpermute gather are not worth paying.
    tier_layout = None
    if tier_stats:
        import itertools

        V, f_last = n_in[-1], fan[-1]

        def prefix_cap(counts):
            hi, lo = max(counts), min(counts)
            return min(_round_up(int((hi + (hi - lo)) * scale)), V)

        cands = sorted(t for t, c in tier_stats.items()
                       if t < f_last and c)
        best = None
        for k in (1, 2, 3):
            for combo in itertools.combinations(cands, k):
                ths = sorted(combo, reverse=True)   # descending widths
                # prefix j holds vertices with deg > ths[j]; caps from
                # the margined prefix counts, forced monotone
                pref = []
                for t in ths:
                    p = prefix_cap(tier_stats[t])
                    if pref and p < pref[-1]:
                        p = pref[-1]
                    pref.append(p)
                if pref[-1] >= V:
                    continue
                caps = [pref[0]] + [
                    pref[i] - pref[i - 1] for i in range(1, len(pref))
                ] + [V - pref[-1]]
                widths = [f_last] + list(ths)
                slots = sum(c * w for c, w in zip(caps, widths))
                if best is None or slots < best[0]:
                    best = (slots, tuple(zip(caps, widths)))
        if best is not None and best[0] < 0.9 * n_edge[-1]:
            n_edge[-1] = best[0]
            tier_layout = best[1]

    return SamplePlan(
        batch_size=batch_size,
        fanouts=fan,
        num_input_cap=tuple(n_in),
        num_edge_cap=tuple(n_edge),
        num_unique_cap=tuple(n_uniq),
        tier_layout=tier_layout,
    )

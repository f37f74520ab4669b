"""Static step-index schedules for the inference loop.

``update_x_at`` / ``update_p_at`` / ``accumulate_p_at`` accept
``"all" | "last" | "last_half" | "never"`` or an explicit list of step
indices.  Because schedules are static Python data, the engine splits the T
steps into segments so parameter gradients are only computed on steps whose
contribution can actually reach a parameter update.  The same plans as the
JAX package's, so a plan means the same steps in both.
"""

from __future__ import annotations

import dataclasses
import typing as tp

ScheduleLike = tp.Union[str, tp.Sequence[int]]


def parse_schedule(spec: ScheduleLike, T: int) -> tp.Tuple[int, ...]:
    """Expand a schedule spec to a sorted tuple of step indices in [0, T)."""
    if isinstance(spec, str):
        if spec == "all":
            return tuple(range(T))
        if spec == "last":
            return (T - 1,)
        if spec == "last_half":
            return tuple(range(T))[int(T / 2):]
        if spec == "never":
            return ()
        raise ValueError(f"unknown schedule {spec!r}")
    steps = tuple(sorted(set(int(t) for t in spec)))
    if steps and (steps[0] < 0 or steps[-1] >= T):
        raise ValueError(f"schedule steps {steps} out of range [0, {T})")
    return steps


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of inference steps the engine runs as one loop.

    Attributes:
        start / length: step range [start, start+length).
        with_p_grads: compute parameter gradients in this segment.
        update_x_mask: per-step x-update mask; None means "all steps update"
            (lets the engine skip masking entirely on the hot path).
        p_zero_mask: per-step "zero the accumulated parameter grads before
            this step's contribution" mask (None = never in this segment).
        p_update_at_end: apply the parameter-optimizer step after the segment.
    """

    start: int
    length: int
    with_p_grads: bool
    update_x_mask: tp.Optional[tp.Tuple[bool, ...]]
    p_zero_mask: tp.Optional[tp.Tuple[bool, ...]]
    p_update_at_end: bool
    # dense schedule (update_p_at='all' without accumulation): the parameter
    # optimizer steps inside the loop each step instead of splitting the run
    # into T single-step segments
    p_update_every_step: bool = False


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    T: int
    update_x_at: tp.Tuple[int, ...]
    update_p_at: tp.Tuple[int, ...]
    accumulate_p_at: tp.Tuple[int, ...]
    p_zero_steps: tp.Tuple[int, ...]
    p_grad_needed: tp.Tuple[bool, ...]
    segments: tp.Tuple[Segment, ...]
    p_divisor_steps: int  # len(accumulate) if accumulating else 1


def build_plan(
    T: int,
    update_x_at: ScheduleLike = "all",
    update_p_at: ScheduleLike = "all",
    accumulate_p_at: ScheduleLike = "never",
    force_p_grads: bool = False,
) -> SchedulePlan:
    """Derive the segment plan from the trainer's schedule logic.

    Semantics: every step's backward adds to
    parameter grads; grads are zeroed (a) at update steps not inside the
    accumulation window, and (b) once at the first accumulation step; the
    parameter step at ``u`` therefore consumes contributions from the last
    zero event at or before ``u`` through ``u`` inclusive, scaled by
    ``len(accumulate)*B`` (accumulating) or ``B``.
    """
    ux = parse_schedule(update_x_at, T)
    up = parse_schedule(update_p_at, T)
    acc = parse_schedule(accumulate_p_at, T)

    # dense p-updates run as ONE segment with an in-loop optimizer step —
    # the default update_p_at='all' would otherwise become T single-step
    # segments
    if up == tuple(range(T)) and not acc and not force_p_grads:
        ux_set_ = set(ux)
        xm = tuple(t in ux_set_ for t in range(T))
        x_mask = None if all(xm) else (xm if any(xm) else tuple([False] * T))
        # with_p_grads stays False: the dense path computes parameter grads
        # through its own argnums and never touches the pgrad accumulator
        seg = Segment(
            start=0, length=T, with_p_grads=False,
            update_x_mask=x_mask, p_zero_mask=None,
            p_update_at_end=False, p_update_every_step=True,
        )
        return SchedulePlan(
            T=T, update_x_at=ux, update_p_at=up, accumulate_p_at=acc,
            p_zero_steps=tuple(up), p_grad_needed=tuple([True] * T),
            segments=(seg,), p_divisor_steps=1,
        )

    zero_steps = sorted(
        set(u for u in up if u not in acc) | ({acc[0]} if acc else set())
    )

    # Which steps' parameter gradients can reach an update.  With an
    # early-stop predicate (force_p_grads) any step up to the last update can
    # become the effective update step, so grads stay live throughout.
    needed = [False] * T
    if force_p_grads and up:
        for t in range(0, max(up) + 1):
            needed[t] = True
    else:
        for u in up:
            z = 0
            for zs in zero_steps:
                if zs <= u:
                    z = max(z, zs)
            for t in range(z, u + 1):
                needed[t] = True

    ux_set = set(ux)
    zero_set = set(zero_steps)
    up_set = set(up)

    # Segment boundaries: changes in `needed`, and after each p-update step.
    boundaries = {0, T}
    for t in range(1, T):
        if needed[t] != needed[t - 1]:
            boundaries.add(t)
    for u in up:
        boundaries.add(u + 1)
    cuts = sorted(boundaries)

    segments = []
    for s, e in zip(cuts[:-1], cuts[1:]):
        length = e - s
        xm = tuple(t in ux_set for t in range(s, e))
        x_mask = None if all(xm) else (xm if any(xm) else tuple([False] * length))
        zm = tuple(t in zero_set for t in range(s, e))
        z_mask = zm if any(zm) else None
        segments.append(
            Segment(
                start=s,
                length=length,
                with_p_grads=any(needed[s:e]),
                update_x_mask=x_mask,
                p_zero_mask=z_mask,
                p_update_at_end=(e - 1) in up_set,
            )
        )

    if len(segments) > 64:
        import warnings

        warnings.warn(
            f"schedule produces {len(segments)} segments. Sparse mid-run "
            "update_p_at lists fragment the run; prefer 'all', 'last', or an "
            "accumulation window.",
            RuntimeWarning,
        )

    return SchedulePlan(
        T=T,
        update_x_at=ux,
        update_p_at=up,
        accumulate_p_at=acc,
        p_zero_steps=tuple(zero_steps),
        p_grad_needed=tuple(needed),
        segments=tuple(segments),
        p_divisor_steps=len(acc) if acc else 1,
    )

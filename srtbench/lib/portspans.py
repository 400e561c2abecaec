"""The port's own spans, as the per-layer metrics read them.

The port (``srt_tpu_torch.utils.profiling``) adds the host seconds of
every span closed outside a profiler window to an in-memory aggregate,
``span_totals() -> {path: (calls, seconds)}``, keyed by the span's path:
its open spans from the outermost down, joined by ``/``
(``srt.render/srt.bounce.2/srt.shade/srt.walk``).  ``totals()`` finds that
aggregate in the running process without importing anything: a process
that never loaded the port's profiling module, or a port without spans,
gives None, and so does every metric built on it.

Per-frame values count the spans under a root ``srt.render`` (one
``RenderPlan.render`` call), so the render plan's probe frame, which runs
under ``srt.setup.plan``, is left out."""

import sys

MODULE = "srt_tpu_torch.utils.profiling"
RENDER = "srt.render"
SHADE = "srt.shade"
WALK = "srt.walk"
PLAN = "srt.setup.plan"
KERNELS = "srt.setup.kernels"
FLATTEN = "srt.setup.flatten"


def totals():
    """The port's span aggregate, or None where the port keeps none."""
    read = getattr(sys.modules.get(MODULE), "span_totals", None)
    return read() if read is not None else None


def seconds(tot: dict, name: str, under=None, not_under=None,
            root=None) -> float:
    """Seconds of the outermost ``name`` spans (none of their own kind
    above them), only those with ``under`` among their ancestors and none
    of ``not_under``, and only in paths that start at ``root``."""
    out = 0.0
    for path, (_, sec) in tot.items():
        names = path.split("/")
        above = names[:-1]
        if (names[-1] != name or name in above
                or (root is not None and names[0] != root)
                or (under is not None and under not in above)
                or (not_under is not None and not_under in above)):
            continue
        out += sec
    return out


def frame_ms(tot: dict, stage: str):
    """Host ms a frame of one stage of ``RenderPlan.render``, the three
    adding up to the ``srt.render`` spans: ``"walk"``, every walk;
    ``"shade"``, the bounce steps less their walks; ``"plan"``, the rest
    of the frame (ray generation, compaction, the uniforms, the final
    scatter and mean, and any walk outside a bounce step).  None without
    a frame."""
    frames, render_s = tot.get(RENDER, (0, 0.0))
    if not frames:
        return None
    shade_s = seconds(tot, SHADE, root=RENDER)
    walk_in_shade = seconds(tot, WALK, under=SHADE, root=RENDER)
    if stage == "walk":
        sec = seconds(tot, WALK, root=RENDER)
    elif stage == "shade":
        sec = shade_s - walk_in_shade
    elif stage == "plan":
        sec = (render_s - shade_s
               - seconds(tot, WALK, not_under=SHADE, root=RENDER))
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return 1e3 * sec / frames

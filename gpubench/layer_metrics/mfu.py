"""The whole step's share of the card's peak, in %: the reference's FLOPs
of the window's work (gpubench.roofline.model_flops at the cell's shapes,
counted here, after the window, so that no untraced run pays for it) over
the unprofiled window's wall time on the host's clock, over the peak of
the arithmetic the recipe keeps (gpubench.roofline.mfu_peak) times the
chips."""

from gpubench import roofline


def read(metric, ctx):
    w = ctx.window
    if not w["units"] or w["wall_s"] <= 0:
        return None
    flops = roofline.model_flops(ctx.geometry, **ctx.flop_shapes)
    rate = flops * w["units"] / w["wall_s"]
    return 100.0 * rate / (roofline.mfu_peak(ctx.compute, ctx.peaks)
                           * ctx.chips)

"""Host seconds of building the render plan (``make_render_plan``: its
hit functions, the probe frame, the width schedule): the port's
``srt.setup.plan`` span less any ``srt.setup.kernels`` span inside it
(the kernel library's first load or build), read from the port's span
aggregate (``lib/portspans``)."""

from srtbench.lib import portspans

UNIT = "s"
LAYER = "set-up (models/fastpath.make_render_plan)"
MOVES = "setup_s"


def read(r):
    tot = portspans.totals()
    if not tot:
        return None
    plan = portspans.seconds(tot, portspans.PLAN)
    if plan <= 0:
        return None
    return plan - portspans.seconds(tot, portspans.KERNELS,
                                    under=portspans.PLAN)

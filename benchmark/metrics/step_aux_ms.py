"""loss layer: the auxiliary heads' widened assignment (a second SimOTA pass
on the lead predictions) and their loss inside the captured train step: the
start of the mark after ``step_aux`` less the start of
``mark_step_aux_kernel``, mean over the complete step sequences of the
traced window (``harness/marks.py``). Nothing to read where the program
emits no such mark."""
from harness.marks import phases


def read(ctx):
    marks = ctx.get("marks")
    if not marks:
        return None
    return phases(marks, "step").get("step_aux")

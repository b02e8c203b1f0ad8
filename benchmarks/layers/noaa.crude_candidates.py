"""NOAA decoder: candidates a decode that the crude sync copies to the host
(both needles), from the program's counter `noaa.crude_sync.candidates`:
the profiler session's tally (`models.stages.session_counts`), counted
while the window was traced, over the window's decodes. None when the
program keeps no such tally or counted nothing under that name."""

COUNTER = "noaa.crude_sync.candidates"


def read(ctx):
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    if COUNTER not in tally or not ctx["records"]:
        return None
    return tally[COUNTER] / len(ctx["records"])

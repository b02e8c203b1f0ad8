"""NOAA bank decoder: device batches a decode of the accurate sync, whose
windows are those of every useful channel, A and B (`WINDOW_GROUP` rows a
batch), from the program's counter `noaa_bank.accurate_sync.batches`: the
profiler session's tally (`models.stages.session_counts`), counted while
the window was traced, over the window's decodes. None when the program
keeps no such tally or counted nothing under that name."""

COUNTER = "noaa_bank.accurate_sync.batches"


def read(ctx):
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    if COUNTER not in tally or not ctx["records"]:
        return None
    return tally[COUNTER] / len(ctx["records"])

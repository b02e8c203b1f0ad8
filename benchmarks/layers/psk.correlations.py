"""PSK decoder: frame correlations a decode that pass 2 runs, from the
program's counter `psk.pass2.correlations`: the profiler session's tally
(`models.stages.session_counts`), counted while the window was traced,
over the window's decodes. None when the program keeps no such tally or
counted nothing under that name."""

COUNTER = "psk.pass2.correlations"


def read(ctx):
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    if COUNTER not in tally or not ctx["records"]:
        return None
    return tally[COUNTER] / len(ctx["records"])

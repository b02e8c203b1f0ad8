"""PSK decoder, Meteor: windows of the filtered stream that pass 2 copies
to the host a decode (stale windows included, the whole-capture path's dry
run excluded), from the program's counter `psk.pass2.windows`: the
profiler session's tally (`models.stages.session_counts`), counted while
the window was traced, over the window's decodes. None when the program
keeps no such counter."""

COUNTER = "psk.pass2.windows"


def read(ctx):
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    if COUNTER not in tally or not ctx["records"]:
        return None
    return tally[COUNTER] / len(ctx["records"])

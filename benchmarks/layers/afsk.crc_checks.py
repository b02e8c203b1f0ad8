"""AFSK decoder: segments between flags a decode that pass the length
tests and go to the CRC, from the program's counter
`afsk.framing.crc_checks`: the profiler session's tally
(`models.stages.session_counts`), counted while the window was traced,
over the window's decodes. None when the program keeps no such counter."""

COUNTER = "afsk.framing.crc_checks"


def read(ctx):
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    if COUNTER not in tally or not ctx["records"]:
        return None
    return tally[COUNTER] / len(ctx["records"])

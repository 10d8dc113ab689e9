"""Share of K2's launches that ran its FM instance, the channelizer with the
discriminator in its epilogue: the program's counter
``channelizer.fm_epilogue`` over ``fused_channelizer_apply``'s launches, both
counted whether tracing is on or off, over the process; None where the
process made no K2 launch, or the program keeps no such counter (a program
without the FM instance)."""

from portbench.layer_metrics import _program


def read(rec):
    program = _program.totals()
    if program is None:
        return None
    launches = program["launches"].get("fused_channelizer_apply", 0)
    fm = program["counters"].get("channelizer.fm_epilogue")
    return fm / launches if launches and fm is not None else None

"""Decision plane: its share of the decode iteration on the card, %.

The device time of the decode programs' decision (the engine's
``device_sample`` spans with ``program`` "decode") over the device time
of the ``dispatch`` spans that hold them, paired by step, in the window
outside the profiler's stretch. Both are CUDA-event times on the
engine's stream (``device_ms``), so a host-bound step counts the waits
for the host's launches on both sides."""


def read(name, run):
    whole = {}
    for e in run.quiet_spans("dispatch"):
        a = dict(e.args)
        if "device_ms" in a:
            whole[a["step"]] = a["device_ms"]
    num = den = 0.0
    for e in run.quiet_spans("device_sample"):
        a = dict(e.args)
        if a.get("program") == "decode" and "device_ms" in a \
                and a["step"] in whole:
            num += a["device_ms"]
            den += whole.pop(a["step"])
    return num / den * 100 if den else None

"""Milliseconds of the card's stream under the program's ``flowtron.lstm``
spans (every flow's attention LSTM and two-layer LSTM over whole packed
sequences) in the forward of the profiled training step, from the
program's ``summary()``. Nothing to read where the program has no such
span."""


def read(run):
    span = run.profiled.get("spans", {}).get("flowtron.lstm")
    if not span or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"]

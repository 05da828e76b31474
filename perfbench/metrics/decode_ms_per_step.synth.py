"""Milliseconds a decoder step of the synthesis entry (``Tacotron2.infer``:
encoder, the decoder loop, postnet), from the benchmark's synchronized host
spans around each call over the window, divided by the decoder steps those
calls took."""


def read(run):
    spans = run.spans.get("taco")
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(n for _, n in spans)

"""Milliseconds of ``WaveGlow.infer`` a second of audio it produced (the
padded batch's), from the benchmark's synchronized host spans around each
call over the window."""


def read(run):
    spans = run.spans.get("vocoder")
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(a for _, a in spans)

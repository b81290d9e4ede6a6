"""audio_s_per_s: audio seconds of every batch yielded inside the
window, over the window's seconds."""

from benchmark.yardstick import SAMPLE_RATE


def read(run):
    samples = sum(int(lens[lens > 0].sum()) for _, _, lens in run.in_window())
    return samples / SAMPLE_RATE / run.seconds

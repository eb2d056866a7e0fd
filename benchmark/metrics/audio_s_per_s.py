"""audio_s_per_s: frames completed in the window over the window's seconds,
at 100 frames an audio second.  All the work over all the time: the window
runs from the first request's start to the last one's end."""

FRAMES_PER_AUDIO_SECOND = 100


def read(run):
    if not run.requests:
        return None
    frames = sum(r.counts["frames"] for r in run.requests if r.ok)
    window = run.requests[-1].end - run.requests[0].start
    return frames / window / FRAMES_PER_AUDIO_SECOND

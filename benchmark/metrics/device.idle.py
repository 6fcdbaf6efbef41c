"""device.idle (device.idle.sampleqc, device.idle.overlap): share of the
traced window in which nothing ran on the card. One reader for every
kind of cell; the manifest names it once per end-to-end metric it
moves."""


def read(run):
    if not run.get("window_s") or run.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])

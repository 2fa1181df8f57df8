"""Milliseconds the train step waited on the prefetch queue per batch in
the traced window: the trainer's ``loader_stats`` (``wait_s``, ``batches``,
kept by ``data/loader.py::prefetch_to_device``) over the window."""


def read(ctx):
    work = ctx["window"].work
    if not work.get("steps"):
        return None
    return 1e3 * work["wait_s"] / work["steps"]

"""Images per device call of the micro-batcher in the traced window: the
``BatchingServer``'s ``stats()`` counters ``submitted`` over ``groups``,
taken before and after the window."""


def read(ctx):
    work = ctx["window"].work
    if not work.get("groups"):
        return None
    return work["submitted"] / work["groups"]

"""SHA-256 compressions the host ran in expand_message_xmd a message, as
the program counts them (`h2c.XMD_HOST_BLOCKS`, which the native hashing
feeds with the compressions it ran), over the calls of the window that
report them."""


def read(run):
    calls = [c for c in run.calls
             if getattr(c.out, "host_blocks", None) is not None]
    if not calls:
        return None
    return (sum(c.out.host_blocks for c in calls)
            / sum(run.cell.ring[c.idx].ops for c in calls))

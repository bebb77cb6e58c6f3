"""RFC 6979 DRBG seedings over signatures, as the program counts them
(one a lane a round; a resample continues a seeded DRBG), over the calls
of the window that report them.  Core's grind gives 2 by the arithmetic;
a scheme that seeds spare candidates shows above it."""


def read(run):
    calls = [c for c in run.calls
             if getattr(c.out, "seedings", None) is not None]
    if not calls:
        return None
    return (sum(c.out.seedings for c in calls)
            / sum(run.cell.ring[c.idx].ops for c in calls))

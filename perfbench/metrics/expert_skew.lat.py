"""The routing's skew: over the window's requests and their
mixture-of-experts layers, the largest ratio of the most-loaded expert's
decode tokens to the mean over the layer's experts (1: every expert took
as many). Read from the per-expert token counter that the program's expert
kernel keeps and the ``request`` span carries (``expert_tokens``, one list
of the experts' counts a layer); None where no request span carries one.

At B=1 the expert kernel reads the six chosen experts' matrices once a
step whichever they are, so the skew costs no time there: it reads what
the seeded weights route to (a correct program routes alike on a seed),
and is kept for a cell of more rows a step, where tokens grouped by expert
share an expert's read and a skewed routing leaves some groups long."""
from perfbench import span_readers


def read(run):
    reqs = span_readers.window(run)
    if reqs is None:
        return None
    ratios = []
    for r in reqs:
        for counts in r.span.attrs.get("expert_tokens") or ():
            total = sum(counts)
            if total:
                ratios.append(max(counts) * len(counts) / total)
    return max(ratios) if ratios else None

"""Geweke's checks run on the card (`ops.geweke`, one launch of
csrc/geweke.cu a check): the `geweke.kernel` launches counted under the
`sampler/geweke` spans, over those spans, summed over the window's fits,
%. A program that counts no `geweke.kernel` (one that tests its windows
on the host) has nothing to read here."""
from harness.program import counter, leaf, ratio, under


def _checks(rec) -> int:
    return sum(a[0] for p, a in rec["spans"].items()
               if leaf(p) == "geweke" and under(p, "sampler"))


def read(tr):
    return ratio(tr, lambda r: counter(r, "geweke.kernel", "sampler"),
                 _checks, 100.0,
                 needs=lambda r: counter(r, "geweke.kernel", "sampler") > 0)

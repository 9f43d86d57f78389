"""Share of the VAE cards' device time in the profiled warm blocks that runs
while the DiT's card runs a kernel other than a copy, in %: how far a VAE
on cards of its own hides its decode and re-encode behind the denoise. A
card's time is the union of its kernels; none where the VAE shares the
DiT's card."""
from gpubench import spans


def read(run):
    prof = run["profile"]
    if not prof:
        return None
    cards = prof["cards"]
    dit = spans.Cover(spans.merged((a, b) for a, b, fam in cards[prof["dit_card"]]["kernels"]
                                   if fam != "copy"))
    busy = overlap = 0.0
    for card, c in cards.items():
        if card != prof["dit_card"]:
            for a, b in spans.merged((a, b) for a, b, _ in c["kernels"]):
                busy += b - a
                overlap += dit.covered(a, b)
    return 100.0 * overlap / busy if busy else None

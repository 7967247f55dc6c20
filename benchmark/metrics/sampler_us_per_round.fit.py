"""The chunked Metropolis driver and Geweke (`infer.metropolis`): the
`metropolis` span less its `laplace` span, over the chains' rounds,
summed over requests, us per round."""


def read(tr):
    reqs = [r for r in tr.requests if "metropolis" in r["spans"]]
    rounds = sum(r["n_rounds"] for r in reqs)
    if not rounds:
        return None
    secs = sum(r["spans"]["metropolis"] - r["spans"].get("laplace", 0.0)
               for r in reqs)
    return 1e6 * secs / rounds

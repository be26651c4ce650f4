"""facade: the share of the first pass's calls that visited fewer nodes
than their budget, so that the facade answered without a launch (%)."""


def read(run):
    calls = run.counts.get("first_pass_calls", 0)
    if not calls:
        return None
    return 100.0 * run.counts.get("first_pass_done", 0) / calls

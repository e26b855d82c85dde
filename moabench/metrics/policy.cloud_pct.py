"""Share of the window's finished requests whose fused generation ran on
the remote (cloud) tier: the paper's resource overhead. Layer:
core/policy.py."""


def read(run):
    done = [r for r in run.requests if r["finished"]]
    if not done:
        return None
    return 100.0 * sum(r["tier"] == run.remote for r in done) / len(done)

"""Decision kernels: the least time of the decision plane's work in the
profiled stretch over the device time of the kernels that
``decision_kernels/*.json`` name, %.

The work is one read of each decision's (rows, V) float32 logits and one
token written a row (``frozen/arith.decision_bytes``), at the card's HBM
rate: a decode step decides for every slot, an admission for its rows.
It is the same whatever kernels implement the decision."""
from perfbench.frozen import arith


def read(name, run):
    tr = run.trace
    if tr is None:
        return None
    try:
        bw = arith.peaks(run.device_name)["hbm_bytes_per_s"]
    except KeyError:
        return None
    names = [k["kernel"] for k in run.cell.decision_kernels]
    t = sum(b - a for n, a, b, _ in tr.kernels
            if any(n.startswith(k) for k in names))
    if not t:
        return None
    V = run.cell.config["vocab_size"]
    slots = run.cell.settings["engine"]["slots"]
    rows = slots * len(run.commits_in(tr.t0, tr.t1))
    rows += sum(dict(e.args).get("rows", 0)
                for e in run.spans_of("prefill", tr.t0, tr.t1))
    return arith.decision_bytes(rows, V) / bw / t * 100

"""routing_roofline.rl (kernels): % of their roofline that the B3 / B4 calls
of the traced window reach: those launched in a policy call at the envs'
batch, those launched in an update at the training batch, each shape's
least time over the measured time of all its calls' kernels."""

from benchcore.kernels import ROUTING, routing_roofline


def read(run):
    trace, m, t = run.get("trace"), run["m"], run["traffic"]
    if trace is None or "bw" not in run:
        return None
    bound = measured = 0.0
    for span, B in (("act", t["num_envs"]), ("update", t["batch_size"])):
        ops = [op for op in trace.kernels
               if op.launched is not None and trace.span_at(op.launched) == span]
        shape = (B, m["obs_size"] ** 2, m["num_slots"], m["slot_size"], m["num_slot_heads"])
        share = routing_roofline(ops, shape, run["bw"], run["peak_flops"])
        if share is not None:
            ms = sum(op.end - op.start for op in ops if ROUTING.search(op.name)) / 1e3
            bound += share / 100.0 * ms
            measured += ms
    return 100.0 * bound / measured if measured > 0 else None


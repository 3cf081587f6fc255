"""routing_roofline.pretrain (kernels): % of their roofline that the B3 / B4
calls of the traced window reach, all at the training batch's shape
[batch, obs_size^2 tokens, slots, slot width, heads], whichever plan runs:
their least time (bytes at the card's bandwidth or operations at its fp32
rate, the larger) over the measured time of all their kernels."""

from benchcore.kernels import routing_roofline


def read(run):
    trace, m = run.get("trace"), run["m"]
    if trace is None or "bw" not in run:
        return None
    shape = (run["traffic"]["batch_size"], m["obs_size"] ** 2, m["num_slots"],
             m["slot_size"], m["num_slot_heads"])
    return routing_roofline(trace.kernels, shape, run["bw"], run["peak_flops"])

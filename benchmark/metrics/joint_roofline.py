"""The joint's least time at the microbatch's valid lattice rows (forward
and backward, bf16) over the CUDA-event time of its entry
(``ops/joint_kernel.fused_joint_lse``) at the rows the step runs."""


def read(rec):
    j = rec.values.get("joint")
    if not j or not j["ms"]:
        return None
    return 100.0 * j["bound_ms"] / j["ms"]

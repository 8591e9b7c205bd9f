"""static_copies (count): device copies a replayed frame makes (jit's
copies of the arguments into the graph's static inputs, of its static
outputs into fresh tensors, and those inside the graph)."""


def read(t: dict):
    p = t.get("profile")
    if not p:
        return None
    return p["copy_count"]

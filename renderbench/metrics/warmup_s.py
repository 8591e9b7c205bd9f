"""warmup_s (s): host seconds of the program's eager calls before its
capture (the warm-up; for a pipeline also the call that sizes its
checked capacities), synchronised."""


def read(t: dict):
    return t.get("warmup_s")

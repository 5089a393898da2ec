"""KNOWN-BAD corpus: per-slot fan-out arity drift (too few, too many);
both only explode when a mesh fans the step out."""


def step(model, data, lengths):
    return lengths


def step3(model, data, lengths):
    return data, lengths, model


def fan_out(model, data, lengths):
    ins = [data]
    parts = [step(model.slots[0][j], *ins) for j in range(2)]  # EXPECT[R10]
    return parts


def fan_out3(model, data, lengths):
    return [step3(model.slots[i][0], data, lengths, model) for i in range(2)]  # EXPECT[R10]

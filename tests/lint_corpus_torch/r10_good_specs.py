"""KNOWN-GOOD corpus for R10: each slot's step is passed exactly the
arguments it takes — directly, through a starred list, and through a
module-level table of step functions."""


def step(model, data, lengths):
    return lengths


def step3(model, data, lengths, attr=False):
    return data, lengths, model


_STEPS = {"plain": (step, step3)}


def fan_out(model, data, lengths):
    ins = [data, lengths]
    parts = [step(model.slots[0][j], *ins) for j in range(2)]
    return parts


def fan_out3(model, data, lengths):
    fn = _STEPS["plain"][1]
    return [fn(model.slots[i][0], data, lengths, attr=True) for i in range(2)]

"""data_ms_per_step.train: the host ms a training step of the timing
stretch spends in the program's `data.*` spans (`data.sample`,
`data.augment`)."""

from benchmark.harness.spans import data_ms_per_step, program_spans


def read(run):
    return data_ms_per_step(program_spans(run), run.traffic["traced_steps"])

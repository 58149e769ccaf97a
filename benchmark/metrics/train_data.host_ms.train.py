"""Host milliseconds a step in the training data layer: the harness's clock
around the next batch of `epoch_batches` and its placing on the card, over
the untraced steps."""


def read(run):
    if not run["untraced_steps"]:
        return None
    return 1e3 * run["data_s"] / run["untraced_steps"]

"""The benchmark's harness: the run itself, the inputs made from the seed,
the judges that decide `correct`, and the reduction of traces and counters
to metrics. The drivers of the timed paths are in `benchmark/drivers/`."""

"""One module a kind of traffic, named by its traffic files' `driver` key;
each has a class `Cell` with `setup`, `window`, `release` and `check`."""

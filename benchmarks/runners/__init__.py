"""Runners: the general code that one kind of traffic file runs. A
traffic file names its runner (``"runner": "train"``), and the runner
module of that name exposes ``setup(run)``, ``window(run, seconds)``,
``check(run)`` (the numbers compared, after the window) and
``control(run)`` (the same numbers for the reference computed in the
precision below the configuration's)."""

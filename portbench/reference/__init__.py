"""Plain PyTorch references of what the benchmark's cells run, and the
comparisons that decide a run's ``correct``. Nothing here imports the
program under test: each reference works out from the benchmark's raw
inputs everything the program derives from them."""

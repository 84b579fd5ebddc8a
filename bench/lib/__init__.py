"""The harness's own code: the cell files found by name, the seeded
weights and token stream, the training cell's driver, the trace's
reduction and the numbers that decide `correct`."""

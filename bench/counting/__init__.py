"""The yardstick's arithmetic: the card's peaks, the work and bytes of a
kernel launch, and the model FLOPs of a step. Frozen here: a program
change is read against these counts, not against its own."""

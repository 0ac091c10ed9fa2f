"""What the benchmark measures against: the card's peaks, the least time
of each kernel's work, the model's FLOPs and the reading of the device
trace. Frozen copies of the program's own arithmetic where it had it."""

"""The yardstick's arithmetic: the card's peaks, the operations and bytes
of each kernel family at a shape, and the model FLOPs of a step."""

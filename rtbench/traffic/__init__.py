"""Traffic: the mixes (`<name>.json`) and the one generator that reads
them (`generator.py`)."""

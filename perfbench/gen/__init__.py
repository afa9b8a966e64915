"""The benchmark's own inputs and its frozen yardstick arithmetic."""

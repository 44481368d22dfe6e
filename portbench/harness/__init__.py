"""The yardstick: manifest, inputs, counts, traces and the run itself."""

"""The general drivers a traffic file names under ``driver``: each builds the
system under test from the configuration and the seed, warms the cell's
shapes, runs the window, and compares what the window produced with the
plain reference."""

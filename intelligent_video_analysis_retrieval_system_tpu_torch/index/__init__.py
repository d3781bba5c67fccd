"""The ``.rvdb`` container and the device-resident dense index."""

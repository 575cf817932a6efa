"""Test data of the port: the reference golden outputs the card run is held to."""

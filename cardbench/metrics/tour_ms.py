"""The tour state inside the device final: the card's stream time in
``stage/tour`` (its forest pass, the Euler tour, the sparse tables) per
request."""
from cardbench.stream_spans import per_request_device_ms


def read(run):
    return per_request_device_ms(run, lambda name: name == "stage/tour")

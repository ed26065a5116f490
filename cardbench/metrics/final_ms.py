"""The device final inside the one-shot program: the card's stream time in
``stage/final/<kind>`` (the tour state and the kind's device function) per
request."""
from cardbench.stream_spans import per_request_device_ms


def read(run):
    return per_request_device_ms(
        run, lambda name: name.startswith("stage/final/"))

"""The 2-edge-connected labels inside the device final: the card's stream
time in ``stage/answer/2ecc`` (the Borůvka pass over the certificate less
its bridges, and the labels made canonical) per request; None where the
program opens no such span."""
from cardbench.stream_spans import per_request_device_ms


def read(run):
    return per_request_device_ms(run, lambda name: name == "stage/answer/2ecc")

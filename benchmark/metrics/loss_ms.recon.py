"""Device-stream ms a reconstruction request in the train and test L1 / SSIM
losses and the PSNRs with the metrics' read-back: the port's three
`recon.loss` spans, the idle gaps inside included."""

from benchmark.program_trace import span_ms

LAYER = "stage-1 losses (training/stage1.py, utils/losses.py)"
MOVES = "recon_p90_ms"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "recon.loss")

from repro_torch.roofline.hw import H100  # noqa: F401
from repro_torch.roofline.analysis import analyze_step, summarize_collectives  # noqa: F401

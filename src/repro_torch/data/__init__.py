from repro_torch.data.synthetic import (  # noqa: F401
    RequestGenerator, make_image, make_token_batch, synth_image_batch)
from repro_torch.data.tokenizer import ToyTokenizer  # noqa: F401

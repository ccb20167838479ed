from aat_tpu_torch.serving.engine import (  # noqa: F401
    DecodeEngine, EngineConfig, EngineState, encode_speech_request,
)

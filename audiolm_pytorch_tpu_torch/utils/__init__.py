"""Utilities of the port, held against the JAX package's `utils`."""


class AudioConditionerBase:
    """Marker base class of an audio conditioner (a MuLaN-style audio
    encoder): a callable `(wavs=, namespace=)` -> embeddings (B, L, dim),
    which the LM wrappers' `audio_conditioner=` takes."""


__all__ = ["AudioConditionerBase"]

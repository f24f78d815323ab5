from anemoi_models_tpu_torch.models.encoder_processor_decoder import AnemoiModelEncProcDec

__all__ = ["AnemoiModelEncProcDec"]

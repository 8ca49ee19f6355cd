from srl_tpu_torch.native.framestore import FrameStoreReader, FrameStoreWriter, available

__all__ = ["FrameStoreReader", "FrameStoreWriter", "available"]

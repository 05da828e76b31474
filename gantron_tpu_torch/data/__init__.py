from gantron_tpu_torch.data.dataset import (Batch, DataLoader,
                                            SyntheticDataset, TextMelDataset,
                                            collate, pick_bucket)
from gantron_tpu_torch.data.filelists import (load_cremad_ravdess,
                                              load_filepaths_and_text,
                                              load_vesus, load_vesus_full)
from gantron_tpu_torch.data.wav import load_wav, read_wav, write_wav

__all__ = [
    "Batch", "DataLoader", "SyntheticDataset", "TextMelDataset", "collate",
    "pick_bucket", "load_filepaths_and_text", "load_vesus",
    "load_cremad_ravdess", "load_vesus_full", "load_wav", "read_wav",
    "write_wav",
]

from longqc_tpu_torch.io.fastx import (  # noqa: F401
    guess_format, open_seq_chunk, parse_fastx_chunk, write_fastq,
    FORMAT_BAM, FORMAT_SAM, FORMAT_FASTQ, FORMAT_FASTA, FORMAT_FAST5,
    FORMAT_UNKNOWN,
)

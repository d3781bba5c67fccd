"""``python -m intelligent_video_analysis_retrieval_system_tpu_torch.bench`` entry."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())

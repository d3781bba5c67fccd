"""``python -m intelligent_video_analysis_retrieval_system_tpu_torch`` entry."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

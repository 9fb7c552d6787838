import sys
from pathlib import Path

# the benchmark's package and the port are imported from the checkout's root
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

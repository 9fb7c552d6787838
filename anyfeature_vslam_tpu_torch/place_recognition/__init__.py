"""Place recognition: the bag-of-words vocabulary and the keyframe database."""

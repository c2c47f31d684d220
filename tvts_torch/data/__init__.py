from tvts_torch.data.loader import ShardedLoader
from tvts_torch.data.transforms import video_transform
from tvts_torch.data.video_reader import get_video_len, read_frames_sampled

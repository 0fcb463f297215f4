from .data_processor import DataProcessor
from .point_feature_encoder import PointFeatureEncoder

"""The data path: vocabularies, the packed feature store and its fixture
writer, the dataset and loader, and the device-resident feature and
annotation tables."""
